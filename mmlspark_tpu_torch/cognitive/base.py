"""Cognitive service base machinery: per-row dynamic params + HTTP composition.

The port's copy of ``mmlspark_tpu/cognitive/base.py``, the reference's
cognitive package base (reference:
cognitive/CognitiveServiceBase.scala:29-319). Every cognitive transformer is a
thin declaration — URL, per-row parameters, response schema — composed into an
internal pipeline of [Lambda(build request struct), SimpleHTTPTransformer,
DropColumns], exactly the reference's getInternalTransformer composition
(CognitiveServiceBase.scala:274-300). All heavy lifting (bounded-concurrency
client, retry/backoff, error column) is inherited from the io.http layer.

``ServiceParam`` mirrors the reference's left-or-right params
(CognitiveServiceBase.scala:29-151): a value set once (``set_x``) OR a column
name (``set_x_col``) supplying a per-row value.
"""

from __future__ import annotations

import json
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

from ..core.dataset import Dataset
from ..core.params import HasErrorCol, HasOutputCol, Param, TypeConverters
from ..core.pipeline import PipelineModel, Transformer
from ..io.http import (CustomInputParser, CustomOutputParser,
                       HTTPRequestData, HTTPResponseData,
                       SimpleHTTPTransformer, advanced_handling, send_request)


class ServiceParam:
    """Value-or-column parameter: a static value or a per-row column name."""

    def __init__(self, name: str, doc: str = "", is_required: bool = False,
                 is_url_param: bool = False):
        self.name = name
        self.doc = doc
        self.is_required = is_required
        self.is_url_param = is_url_param

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, "_service_values", {}).get(self.name)


class _HasServiceParams:
    """Mixin: stores static values + column bindings for ServiceParams."""

    def _init_service_params(self):
        if not hasattr(self, "_service_values"):
            self._service_values: Dict[str, Any] = {}
            self._service_cols: Dict[str, str] = {}

    def set_service_param(self, name: str, value: Any):
        self._init_service_params()
        self._service_values[name] = value
        self._service_cols.pop(name, None)
        return self

    def set_service_param_col(self, name: str, col: str):
        self._init_service_params()
        self._service_cols[name] = col
        self._service_values.pop(name, None)
        return self

    def service_param_values(self, dataset: Dataset, i: int) -> Dict[str, Any]:
        """Resolved (static + per-row) service params for row i."""
        self._init_service_params()
        out = dict(self._service_values)
        for name, col in self._service_cols.items():
            out[name] = dataset[col][i]
        return out

    def __getattr__(self, item):
        # set_<p>/set_<p>_col sugar for any declared ServiceParam.
        if item.startswith("set_"):
            cls_params = {k for k in dir(type(self))
                          if isinstance(getattr(type(self), k, None), ServiceParam)}
            if item.endswith("_col") and item[4:-4] in cls_params:
                return lambda v: self.set_service_param_col(item[4:-4], v)
            if item[4:] in cls_params:
                return lambda v: self.set_service_param(item[4:], v)
        raise AttributeError(f"{type(self).__name__} has no attribute {item!r}")


class CognitiveServicesBase(Transformer, _HasServiceParams, HasOutputCol,
                            HasErrorCol):
    """Base for every cognitive transformer.

    Subclasses declare ``ServiceParam`` class attributes and override
    ``build_request(row_params) -> HTTPRequestData`` (the
    HasCognitiveServiceInput.inputFunc analog,
    CognitiveServiceBase.scala:180-234). Response JSON lands in outputCol;
    non-2xx rows get None + an error struct in errorCol.
    """

    subscriptionKey = Param("subscriptionKey", "API subscription key", None,
                            TypeConverters.to_string)
    url = Param("url", "service endpoint URL", None, TypeConverters.to_string)
    concurrency = Param("concurrency", "max in-flight requests", 1,
                        TypeConverters.to_int)
    timeout = Param("timeout", "per-request timeout seconds", 60.0,
                    TypeConverters.to_float)
    backoffs = Param("backoffs", "explicit retry backoff schedule in ms "
                     "(reference: ComputerVision backoffs)", None,
                     TypeConverters.to_list_int)

    def set_subscription_key(self, v: str):
        return self.set(subscriptionKey=v)

    def set_url(self, v: str):
        return self.set(url=v)

    def set_location(self, loc: str):
        """Region shortcut: fills url from the subclass's uri template."""
        return self.set(url=self._uri_from_location(loc))

    def _uri_from_location(self, loc: str) -> str:
        raise NotImplementedError(f"{type(self).__name__} has no uri template")

    # -- request construction ------------------------------------------------
    # services with a non-Azure-cognitive auth header (e.g. search's api-key)
    # override the attribute, not the method
    subscription_key_header = "Ocp-Apim-Subscription-Key"

    def auth_headers(self) -> Dict[str, str]:
        key = self.get_or_default("subscriptionKey")
        h = {"Content-Type": "application/json"}
        if key:
            h[self.subscription_key_header] = key
        return h

    def _split_service_params(self, row_params: Dict[str, Any]):
        """Partition non-None row params into (url_parts, body) by their
        ServiceParam.is_url_param declaration — the one reflection loop
        every request builder shares."""
        cls = type(self)
        url_parts, body = {}, {}
        for name in dir(cls):
            sp = getattr(cls, name, None)
            if isinstance(sp, ServiceParam) and name in row_params:
                v = row_params[name]
                if v is None:
                    continue
                if sp.is_url_param:
                    url_parts[name] = v
                else:
                    body[name] = _jsonable(v)
        return url_parts, body

    def build_request(self, row_params: Dict[str, Any]) -> HTTPRequestData:
        """Default: POST all service params as the JSON body; params declared
        ``is_url_param`` go to the query string instead."""
        url_parts, body = self._split_service_params(row_params)
        url = append_query(self.get_or_default("url"), url_parts)
        return HTTPRequestData(
            url=url, method="POST", headers=self.auth_headers(),
            entity=json.dumps(body).encode("utf-8"))

    def parse_response(self, resp: HTTPResponseData) -> Any:
        try:
            return resp.json()
        except ValueError:
            return None

    # -- the internal pipeline (CognitiveServiceBase.scala:274-300) ----------
    def transform(self, dataset: Dataset) -> Dataset:
        self._init_service_params()
        out_col = self.get_or_default("outputCol") or f"{type(self).__name__}_out"
        err_col = self.get_or_default("errorCol") or "error"

        requests: List[Optional[HTTPRequestData]] = []
        for i in range(len(dataset)):
            rp = self.service_param_values(dataset, i)
            missing = [n for n in self._required_params() if rp.get(n) is None]
            if missing:
                requests.append(None)
                continue
            try:
                requests.append(self.build_request(rp))
            except ValueError:
                # per-row request-shape validation (e.g. VerifyFaces modes)
                # errors THIS row, like a missing required param — it must
                # not abort the whole batch (ErrorUtils semantics)
                requests.append(None)
        staged = dataset.with_column("_cog_request", requests)

        inp = CustomInputParser(udf=lambda r: r)
        # parse_response may poll (async operations) — run it on the same
        # thread-pool width as the exchange so polling isn't serialized.
        outp = _ConcurrentOutputParser(
            udf=self.parse_response,
            concurrency=self.get_or_default("concurrency"))
        http = (SimpleHTTPTransformer(input_parser=inp, output_parser=outp)
                .set(inputCol="_cog_request", outputCol=out_col,
                     errorCol=err_col,
                     concurrency=self.get_or_default("concurrency"),
                     timeout=self.get_or_default("timeout"),
                     backoffs=self.get_or_default("backoffs")))
        return PipelineModel([http]).transform(staged).drop("_cog_request")

    def _required_params(self) -> List[str]:
        return [name for name in dir(type(self))
                if isinstance(getattr(type(self), name, None), ServiceParam)
                and getattr(type(self), name).is_required]

    # persistence of service param state
    def _save_extra(self, path: str) -> None:
        import os
        self._init_service_params()
        with open(os.path.join(path, "service_params.json"), "w") as f:
            json.dump({"values": _jsonable(self._service_values),
                       "cols": self._service_cols}, f)

    def _load_extra(self, path: str) -> None:
        import os
        self._init_service_params()
        fp = os.path.join(path, "service_params.json")
        if os.path.exists(fp):
            with open(fp) as f:
                d = json.load(f)
            self._service_values = d["values"]
            self._service_cols = d["cols"]


class _ConcurrentOutputParser(CustomOutputParser):
    """CustomOutputParser that maps rows on a bounded thread pool (needed for
    polling services, where parsing a row blocks on the operation result)."""

    def __init__(self, udf=None, concurrency: int = 1, **kwargs):
        super().__init__(udf=udf, **kwargs)
        self.concurrency = max(1, int(concurrency or 1))

    def transform(self, dataset: Dataset) -> Dataset:
        in_col = self.get_or_default("inputCol")
        out_col = self.get_or_default("outputCol") or "parsed"
        col = dataset[in_col]
        if self.concurrency == 1:
            out = [None if r is None else self.udf(r) for r in col]
        else:
            with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
                futs = [None if r is None else pool.submit(self.udf, r)
                        for r in col]
                out = [None if f is None else f.result() for f in futs]
        return dataset.with_column(out_col, out)


class PollingCognitiveService(CognitiveServicesBase):
    """Async-operation services: POST returns 202 + Operation-Location; poll
    until status terminal (reference: ComputerVision.scala RecognizeText
    polling loop, cognitive/ComputerVision.scala:200-319)."""

    pollingDelay = Param("pollingDelay", "seconds between polls", 0.3,
                         TypeConverters.to_float)
    maxPollingRetries = Param("maxPollingRetries", "max polls", 100,
                              TypeConverters.to_int)

    def parse_response(self, resp: HTTPResponseData) -> Any:
        import time
        loc = resp.headers.get("operation-location")
        if resp.status_code != 202 or not loc:
            return super().parse_response(resp)
        delay = self.get_or_default("pollingDelay")
        headers = self.auth_headers()
        for _ in range(self.get_or_default("maxPollingRetries")):
            time.sleep(delay)
            poll = send_request(HTTPRequestData(url=loc, headers=headers),
                                timeout=self.get_or_default("timeout"))
            try:
                body = poll.json()
            except ValueError:
                continue
            status = str(body.get("status", "")).lower()
            if status in ("succeeded", "failed"):
                return body
        return None


def _jsonable(v: Any) -> Any:
    from ..io.http import to_jsonable
    return to_jsonable(v)


def append_query(url: str, params: Dict[str, Any]) -> str:
    """Append URL-encoded query parameters (spaces, '&', unicode all safe)."""
    if not params:
        return url
    encoded = urllib.parse.urlencode(
        {k: str(v) for k, v in params.items() if v is not None})
    return url + ("&" if "?" in url else "?") + encoded
