"""The cognitive service transformer catalog.

The port's copy of ``mmlspark_tpu/cognitive/services.py``. Parity with the
reference's ~30 service stages (reference:
cognitive/ComputerVision.scala:165-529, TextAnalytics.scala, Face.scala,
SpeechToText.scala, AnamolyDetection.scala:23-153, AzureSearch.scala:26-136,
BingImageSearch.scala:27-66). Each class is a declaration over
CognitiveServicesBase: endpoint template + ServiceParams + (optionally) a
custom request builder. Everything else — per-row params, async client,
retries, error column, polling — is inherited.
"""

from __future__ import annotations

import json

import numpy as np
from typing import Any, Dict, List, Optional

from ..core.dataset import Dataset
from ..core.params import Param, TypeConverters
from ..io.http import HTTPRequestData, advanced_handling, to_jsonable
from .base import (CognitiveServicesBase, PollingCognitiveService,
                   ServiceParam, append_query)

# ---------------------------------------------------------------------------
# Computer Vision (cognitive/ComputerVision.scala)
# ---------------------------------------------------------------------------


class _VisionBase(CognitiveServicesBase):
    """Vision services accept either an image URL (JSON body) or raw bytes."""

    imageUrl = ServiceParam("imageUrl", "image URL")
    imageBytes = ServiceParam("imageBytes", "raw image bytes")

    def build_request(self, rp: Dict[str, Any]) -> HTTPRequestData:
        url = self._query_url(rp)
        if rp.get("imageBytes") is not None:
            headers = self.auth_headers()
            headers["Content-Type"] = "application/octet-stream"
            return HTTPRequestData(url=url, method="POST", headers=headers,
                                   entity=bytes(rp["imageBytes"]))
        body = json.dumps({"url": rp.get("imageUrl")}).encode()
        return HTTPRequestData(url=url, method="POST",
                               headers=self.auth_headers(), entity=body)

    def _query_url(self, rp: Dict[str, Any]) -> str:
        return append_query(self.get_or_default("url"), self._query_params(rp))

    def _query_params(self, rp: Dict[str, Any]) -> Dict[str, Any]:
        return {}


class OCR(_VisionBase):
    """Printed-text OCR (ComputerVision.scala OCR)."""

    language = ServiceParam("language", "BCP-47 language code")
    detectOrientation = ServiceParam("detectOrientation", "auto-rotate")

    def _query_params(self, rp):
        out = {}
        if rp.get("language"):
            out["language"] = rp["language"]
        if rp.get("detectOrientation") is not None:
            out["detectOrientation"] = str(bool(rp["detectOrientation"])).lower()
        return out


class RecognizeText(_VisionBase, PollingCognitiveService):
    """Handwritten/printed text via async operation + polling
    (ComputerVision.scala:200-319)."""

    mode = ServiceParam("mode", "Handwritten or Printed")

    def _query_params(self, rp):
        return {"mode": rp["mode"]} if rp.get("mode") else {}


class AnalyzeImage(_VisionBase):
    visualFeatures = ServiceParam("visualFeatures", "features to extract")
    details = ServiceParam("details", "domain-specific details")
    language = ServiceParam("language", "output language")

    def _query_params(self, rp):
        out = {}
        if rp.get("visualFeatures"):
            out["visualFeatures"] = ",".join(rp["visualFeatures"])
        if rp.get("details"):
            out["details"] = ",".join(rp["details"])
        if rp.get("language"):
            out["language"] = rp["language"]
        return out


class TagImage(_VisionBase):
    pass


class DescribeImage(_VisionBase):
    maxCandidates = ServiceParam("maxCandidates", "caption candidates")

    def _query_params(self, rp):
        return ({"maxCandidates": rp["maxCandidates"]}
                if rp.get("maxCandidates") else {})


class GenerateThumbnails(_VisionBase):
    width = ServiceParam("width", "thumbnail width")
    height = ServiceParam("height", "thumbnail height")
    smartCropping = ServiceParam("smartCropping", "smart crop")

    def _query_params(self, rp):
        out = {}
        for k in ("width", "height"):
            if rp.get(k) is not None:
                out[k] = rp[k]
        if rp.get("smartCropping") is not None:
            out["smartCropping"] = str(bool(rp["smartCropping"])).lower()
        return out

    def parse_response(self, resp):
        # thumbnail bytes, not JSON
        return resp.entity


class RecognizeDomainSpecificContent(_VisionBase):
    """Celebrity/landmark models (ComputerVision.scala DSIR)."""

    model = ServiceParam("model", "domain model name", is_required=True)


# ---------------------------------------------------------------------------
# Text Analytics (cognitive/TextAnalytics.scala)
# ---------------------------------------------------------------------------


class _TextAnalyticsBase(CognitiveServicesBase):
    """Documents-array request shape shared by all text services.

    ``_ta_version``/``_ta_path`` drive the region-shortcut URL the same way
    the reference's per-class setUrl templates do
    (cognitive/TextAnalytics.scala:177-325): unversioned classes target
    v3.0, the *V2 variants keep the v2.0-era endpoints.
    """

    text = ServiceParam("text", "document text", is_required=True)
    language = ServiceParam("language", "document language")
    modelVersion = ServiceParam("modelVersion",
                                "model-version query param (v3 API)")
    showStats = ServiceParam("showStats",
                             "include statistics in the response")
    _ta_version = "v3.0"
    _ta_path = ""

    def _uri_from_location(self, loc: str) -> str:
        return (f"https://{loc}.api.cognitive.microsoft.com/text/analytics/"
                f"{self._ta_version}/{self._ta_path}")

    def build_request(self, rp: Dict[str, Any]) -> HTTPRequestData:
        texts = rp["text"]
        if isinstance(texts, str):
            texts = [texts]
        langs = rp.get("language") or ["en"] * len(texts)
        if isinstance(langs, str):
            langs = [langs] * len(texts)
        docs = [{"id": str(i), "language": l, "text": t}
                for i, (t, l) in enumerate(zip(texts, langs))]
        return HTTPRequestData(
            url=append_query(self.get_or_default("url"),
                             self._ta_query(rp)),
            method="POST", headers=self.auth_headers(),
            entity=json.dumps({"documents": docs}).encode())

    def _ta_query(self, rp):
        """v3 query params shared by every text-analytics builder."""
        q = {}
        if rp.get("modelVersion") is not None:
            q["model-version"] = rp["modelVersion"]
        if rp.get("showStats") is not None:
            q["showStats"] = str(bool(rp["showStats"])).lower()
        return q


class TextSentiment(_TextAnalyticsBase):
    _ta_path = "sentiment"


class KeyPhraseExtractor(_TextAnalyticsBase):
    _ta_path = "keyPhrases"


class NER(_TextAnalyticsBase):
    _ta_path = "entities/recognition/general"


class LanguageDetector(_TextAnalyticsBase):
    _ta_path = "languages"

    def build_request(self, rp):
        # language detection docs carry no language field (the base
        # builder would inject the 'en' default); query params are shared
        texts = rp["text"]
        if isinstance(texts, str):
            texts = [texts]
        docs = [{"id": str(i), "text": t} for i, t in enumerate(texts)]
        return HTTPRequestData(
            url=append_query(self.get_or_default("url"),
                             self._ta_query(rp)),
            method="POST", headers=self.auth_headers(),
            entity=json.dumps({"documents": docs}).encode())


class EntityDetector(_TextAnalyticsBase):
    _ta_path = "entities/linking"


class TextSentimentV2(TextSentiment):
    _ta_version = "v2.0"


class KeyPhraseExtractorV2(KeyPhraseExtractor):
    _ta_version = "v2.0"


class NERV2(NER):
    _ta_version = "v2.1"
    _ta_path = "entities"


class LanguageDetectorV2(LanguageDetector):
    _ta_version = "v2.0"


class EntityDetectorV2(EntityDetector):
    _ta_version = "v2.0"
    _ta_path = "entities"


# ---------------------------------------------------------------------------
# Face (cognitive/Face.scala)
# ---------------------------------------------------------------------------


class DetectFace(_VisionBase):
    returnFaceId = ServiceParam("returnFaceId", "include face ids")
    returnFaceLandmarks = ServiceParam("returnFaceLandmarks", "landmarks")
    returnFaceAttributes = ServiceParam("returnFaceAttributes", "attributes")

    def _query_params(self, rp):
        out = {}
        if rp.get("returnFaceId") is not None:
            out["returnFaceId"] = str(bool(rp["returnFaceId"])).lower()
        if rp.get("returnFaceLandmarks") is not None:
            out["returnFaceLandmarks"] = str(bool(rp["returnFaceLandmarks"])).lower()
        if rp.get("returnFaceAttributes"):
            out["returnFaceAttributes"] = ",".join(rp["returnFaceAttributes"])
        return out


class FindSimilarFace(CognitiveServicesBase):
    faceId = ServiceParam("faceId", "probe face id", is_required=True)
    faceIds = ServiceParam("faceIds", "candidate face ids")
    faceListId = ServiceParam("faceListId", "candidate face list")
    largeFaceListId = ServiceParam("largeFaceListId",
                                   "candidate large face list")
    maxNumOfCandidatesReturned = ServiceParam("maxNumOfCandidatesReturned",
                                              "max candidates")
    mode = ServiceParam("mode", "matchPerson or matchFace")


class GroupFaces(CognitiveServicesBase):
    faceIds = ServiceParam("faceIds", "face ids to group", is_required=True)


class IdentifyFaces(CognitiveServicesBase):
    faceIds = ServiceParam("faceIds", "probe ids", is_required=True)
    personGroupId = ServiceParam("personGroupId", "person group")
    largePersonGroupId = ServiceParam("largePersonGroupId",
                                      "large person group")
    maxNumOfCandidatesReturned = ServiceParam("maxNumOfCandidatesReturned",
                                              "max candidates")
    confidenceThreshold = ServiceParam("confidenceThreshold", "threshold")


class VerifyFaces(CognitiveServicesBase):
    faceId1 = ServiceParam("faceId1", "first face (face-to-face mode)")
    faceId2 = ServiceParam("faceId2", "second face (face-to-face mode)")
    faceId = ServiceParam("faceId", "probe face (face-to-person mode)")
    personId = ServiceParam("personId", "person to verify against")
    personGroupId = ServiceParam("personGroupId", "person's group")
    largePersonGroupId = ServiceParam("largePersonGroupId",
                                      "person's large group")

    def build_request(self, rp):
        two_face = (rp.get("faceId1") is not None
                    and rp.get("faceId2") is not None)
        to_person = (rp.get("faceId") is not None
                     and rp.get("personId") is not None
                     and (rp.get("personGroupId") is not None
                          or rp.get("largePersonGroupId") is not None))
        if not (two_face or to_person):
            raise ValueError(
                "VerifyFaces needs faceId1+faceId2 (face-to-face) or "
                "faceId+personId+person[Group|LargeGroup]Id "
                "(face-to-person)")
        return super().build_request(rp)


# ---------------------------------------------------------------------------
# Speech (cognitive/SpeechToText.scala — REST short-audio path; the SDK
# streaming path is out of TPU scope per SURVEY.md N5)
# ---------------------------------------------------------------------------


class SpeechToText(CognitiveServicesBase):
    audioData = ServiceParam("audioData", "WAV bytes", is_required=True)
    language = ServiceParam("language", "recognition language",
                            is_url_param=True)
    format = ServiceParam("format", "simple or detailed", is_url_param=True)
    profanity = ServiceParam("profanity", "masked, raw or removed",
                             is_url_param=True)

    def build_request(self, rp):
        url = append_query(self.get_or_default("url"),
                           {k: rp[k] for k in ("language", "format",
                                               "profanity")
                            if rp.get(k)})
        headers = self.auth_headers()
        headers["Content-Type"] = "audio/wav; codecs=audio/pcm; samplerate=16000"
        return HTTPRequestData(url=url, method="POST", headers=headers,
                               entity=bytes(rp["audioData"]))


# ---------------------------------------------------------------------------
# Anomaly Detector (cognitive/AnamolyDetection.scala:23-153)
# ---------------------------------------------------------------------------


class _AnomalyBase(CognitiveServicesBase):
    series = ServiceParam("series", "timestamp/value series", is_required=True)
    granularity = ServiceParam("granularity", "series granularity")
    maxAnomalyRatio = ServiceParam("maxAnomalyRatio", "max anomaly ratio")
    sensitivity = ServiceParam("sensitivity", "sensitivity")
    customInterval = ServiceParam("customInterval", "custom interval")
    period = ServiceParam("period", "fixed seasonal period (rows per "
                          "cycle); omit for auto-detection")


class DetectLastAnomaly(_AnomalyBase):
    pass


class DetectAnomalies(_AnomalyBase):
    pass


class SimpleDetectAnomalies(_AnomalyBase):
    """Group rows by key into series, call the batch endpoint once per group,
    then scatter verdicts back per row (AnamolyDetection.scala
    SimpleDetectAnomalies group-batching)."""

    groupbyCol = Param("groupbyCol", "grouping column", None,
                       TypeConverters.to_string)
    timestampCol = Param("timestampCol", "timestamp column", "timestamp",
                         TypeConverters.to_string)
    valueCol = Param("valueCol", "value column", "value",
                     TypeConverters.to_string)

    def transform(self, dataset: Dataset) -> Dataset:
        self._init_service_params()
        out_col = self.get_or_default("outputCol") or "anomalies"
        err_col = self.get_or_default("errorCol") or "error"
        gcol = self.get_or_default("groupbyCol")
        tcol = self.get_or_default("timestampCol")
        vcol = self.get_or_default("valueCol")

        groups: Dict[Any, List[int]] = {}
        for i in range(len(dataset)):
            key = dataset[gcol][i] if gcol else 0
            groups.setdefault(key, []).append(i)

        n = len(dataset)
        results: List[Any] = [None] * n
        errors: List[Any] = [None] * n
        for key, idxs in groups.items():
            series = [{"timestamp": to_jsonable(dataset[tcol][i]),
                       "value": to_jsonable(dataset[vcol][i])} for i in idxs]
            # static values AND column bindings (first row of the group
            # supplies per-group scalar params like granularity)
            rp = self.service_param_values(dataset, idxs[0])
            rp["series"] = series
            resp = advanced_handling(
                self.build_request(rp),
                backoffs=self.get_or_default("backoffs"),
                timeout=self.get_or_default("timeout"))
            if not (200 <= resp.status_code < 300):
                for i in idxs:
                    errors[i] = resp.to_dict()
                continue
            body = resp.json()
            flags = body.get("isAnomaly", [])
            for pos, i in enumerate(idxs):
                results[i] = {
                    "isAnomaly": flags[pos] if pos < len(flags) else None,
                    "expectedValue": _at(body.get("expectedValues"), pos),
                    "upperMargin": _at(body.get("upperMargins"), pos),
                    "lowerMargin": _at(body.get("lowerMargins"), pos),
                }
        return dataset.with_columns({out_col: results, err_col: errors})


def _at(lst, i):
    return lst[i] if isinstance(lst, list) and i < len(lst) else None


# ---------------------------------------------------------------------------
# Search (cognitive/AzureSearch.scala:26-136, BingImageSearch.scala:27-66)
# ---------------------------------------------------------------------------


class BingImageSearch(CognitiveServicesBase):
    q = ServiceParam("q", "search query", is_required=True, is_url_param=True)
    count = ServiceParam("count", "results per page", is_url_param=True)
    offset = ServiceParam("offset", "result offset", is_url_param=True)
    imageType = ServiceParam("imageType", "image type filter",
                             is_url_param=True)
    aspect = ServiceParam("aspect", "aspect-ratio filter", is_url_param=True)
    color = ServiceParam("color", "color filter", is_url_param=True)
    freshness = ServiceParam("freshness", "discovery-time filter",
                             is_url_param=True)
    imageContent = ServiceParam("imageContent", "content filter",
                                is_url_param=True)
    license = ServiceParam("license", "license filter", is_url_param=True)
    mkt = ServiceParam("mkt", "market/locale", is_url_param=True)
    maxFileSize = ServiceParam("maxFileSize", "max bytes", is_url_param=True)
    minFileSize = ServiceParam("minFileSize", "min bytes", is_url_param=True)
    maxHeight = ServiceParam("maxHeight", "max pixels", is_url_param=True)
    minHeight = ServiceParam("minHeight", "min pixels", is_url_param=True)
    maxWidth = ServiceParam("maxWidth", "max pixels", is_url_param=True)
    minWidth = ServiceParam("minWidth", "min pixels", is_url_param=True)

    def build_request(self, rp):
        # GET: every declared url-param ServiceParam rides the query string
        q, _ = self._split_service_params(rp)
        url = append_query(self.get_or_default("url"), q)
        return HTTPRequestData(url=url, method="GET",
                               headers=self.auth_headers())

    @staticmethod
    def get_urls(dataset: Dataset, search_col: str, url_col: str = "imageUrl"
                 ) -> Dataset:
        """Explode contentUrls out of search responses
        (BingImageSearch.getUrlTransformer)."""
        urls, src = [], []
        for i, body in enumerate(dataset[search_col]):
            for v in (body or {}).get("value", []):
                if v.get("contentUrl"):
                    urls.append(v["contentUrl"])
                    src.append(i)
        return Dataset({url_col: urls, "sourceRow": src})


def _search_upload_batch(url: str, headers: Dict[str, str],
                         docs: List[Dict[str, Any]], timeout: float,
                         what: str, backoffs=None) -> int:
    """POST one document batch to a search index; shared by AddDocuments and
    AzureSearchWriter so the wire contract lives in exactly one place."""
    resp = advanced_handling(
        HTTPRequestData(url=url, method="POST", headers=headers,
                        entity=json.dumps({"value": docs}).encode()),
        backoffs=backoffs, timeout=timeout)
    if not (200 <= resp.status_code < 300):
        raise IOError(f"{what} failed: {resp.status_code} {resp.text}")
    return resp.status_code


class AddDocuments(CognitiveServicesBase):
    """Batched document upload to an Azure Search index as a pipeline stage
    (reference: cognitive/AzureSearch.scala:84-120 — batch rows, rename the
    action column to @search.action, POST to /docs/index with the api-key
    header). The fluent AzureSearchWriter below wraps this flow for whole
    datasets; this stage form composes inside pipelines.

    Batches upload sequentially and in order (the inherited ``concurrency``
    param does not apply: interleaved index actions would reorder
    upload/merge/delete semantics). A failed batch records the error on its
    rows in ``errorCol`` (default "errors", like every cognitive stage) and
    later batches still upload; set errorCol=None to fail fast instead."""

    serviceName = Param("serviceName", "search service name", None,
                        TypeConverters.to_string)
    indexName = Param("indexName", "target index", None,
                      TypeConverters.to_string)
    actionCol = Param("actionCol", "per-row action column",
                      "@search.action", TypeConverters.to_string)
    batchSize = Param("batchSize", "documents per request", 100,
                      TypeConverters.to_int)

    subscription_key_header = "api-key"

    def _uri_from_location(self, loc: str) -> str:  # serviceName, not region
        index = self.get_or_default("indexName")
        if not index:
            raise ValueError("AddDocuments needs indexName= before the url "
                             "can be derived from serviceName")
        return (f"https://{loc}.search.windows.net/indexes/{index}"
                "/docs/index?api-version=2019-05-06")

    def transform(self, dataset: Dataset) -> Dataset:
        url = self.get_or_default("url")
        if not url:
            svc = self.get_or_default("serviceName")
            if not svc:
                raise ValueError("set url= or serviceName= + indexName=")
            url = self._uri_from_location(svc)
        action_col = self.get_or_default("actionCol")
        # default errorCol ("errors", inherited) records failures like every
        # other cognitive stage; explicitly unset it to fail fast instead
        err_col = self.get_or_default("errorCol")
        statuses, errors = [], []
        for batch in dataset.batches(self.get_or_default("batchSize")):
            docs = []
            for row in batch.to_rows():
                doc = {k: to_jsonable(v) for k, v in row.items()
                       if k != action_col}
                doc["@search.action"] = row.get(action_col, "upload")
                docs.append(doc)
            try:
                code = _search_upload_batch(
                    url, self.auth_headers(), docs,
                    self.get_or_default("timeout"), "AddDocuments",
                    backoffs=self.get_or_default("backoffs"))
                statuses.extend([code] * len(docs))
                errors.extend([None] * len(docs))
            except IOError as e:
                if err_col is None:
                    raise
                statuses.extend([-1] * len(docs))
                errors.extend([str(e)] * len(docs))
        out = dataset.with_column("status", np.asarray(statuses, np.int64))
        if err_col is not None:
            out = out.with_column(err_col, errors)
        return out


class AzureSearchWriter:
    """Push a Dataset into a search index in batches
    (AzureSearch.scala AzureSearchWriter + AzureSearchAPI index mgmt)."""

    def __init__(self, service_url: str, index_name: str, api_key: str,
                 batch_size: int = 100, timeout: float = 60.0):
        self.service_url = service_url.rstrip("/")
        self.index_name = index_name
        self.api_key = api_key
        self.batch_size = batch_size
        self.timeout = timeout

    def _headers(self):
        return {"Content-Type": "application/json", "api-key": self.api_key}

    def ensure_index(self, fields: List[Dict[str, Any]]) -> bool:
        """Create the index if missing (AzureSearchAPI.scala:16-42)."""
        url = f"{self.service_url}/indexes/{self.index_name}?api-version=2019-05-06"
        resp = advanced_handling(HTTPRequestData(url=url, headers=self._headers()),
                                 timeout=self.timeout)
        if resp.status_code == 200:
            return False
        body = json.dumps({"name": self.index_name, "fields": fields}).encode()
        url = f"{self.service_url}/indexes?api-version=2019-05-06"
        resp = advanced_handling(
            HTTPRequestData(url=url, method="POST", headers=self._headers(),
                            entity=body), timeout=self.timeout)
        if not (200 <= resp.status_code < 300):
            raise IOError(f"index creation failed: {resp.status_code} {resp.text}")
        return True

    def write(self, dataset: Dataset, action: str = "upload") -> int:
        url = (f"{self.service_url}/indexes/{self.index_name}"
               f"/docs/index?api-version=2019-05-06")
        written = 0
        for batch in dataset.batches(self.batch_size):
            docs = [{**{k: to_jsonable(v) for k, v in row.items()},
                     "@search.action": action} for row in batch.to_rows()]
            _search_upload_batch(url, self._headers(), docs, self.timeout,
                                 "search write")
            written += len(docs)
        return written
