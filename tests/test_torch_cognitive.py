"""The port's cognitive-service stages (``mmlspark_tpu_torch/cognitive``)
against the JAX package's, on local mock servers only.

The 23 scenarios of the JAX package's ``tests/test_cognitive.py`` (OCR by
URL and bytes, a bad key in the error column, polling, query parameters,
per-row and static params, groups, URL explosion, the search writer,
persistence, URL templates, the param tail) and the streaming speech SDK
of ``tests/test_speech_sdk.py``: each runs through both packages against
the same mock, and the port's output columns equal the JAX stages'. These
stages are host clients of REST services, with no device work.
"""

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import mmlspark_tpu.cognitive as jcog
import mmlspark_tpu.io.http as jhttp
from mmlspark_tpu.cognitive import speech_sdk as jsdk
from mmlspark_tpu.core.dataset import Dataset as JDataset
from mmlspark_tpu.core.pipeline import save_stage as jsave_stage
import mmlspark_tpu_torch.cognitive as tcog
import mmlspark_tpu_torch.io.http as thttp
from mmlspark_tpu_torch.cognitive import speech_sdk as tsdk
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.core.pipeline import load_stage, save_stage

PKGS = (SimpleNamespace(name="port", cog=tcog, D=Dataset, http=thttp,
                        sdk=tsdk),
        SimpleNamespace(name="jax", cog=jcog, D=JDataset, http=jhttp,
                        sdk=jsdk))


def both(fn):
    """``fn(pkg)`` for the port, then the JAX package."""
    return [fn(p) for p in PKGS]


def same(fn):
    """``fn(pkg)`` of both packages, held equal; the port's value."""
    t, j = both(fn)
    assert t == j
    return t


def _err(e):
    """An error struct without the response's Date header."""
    if e is None:
        return None
    return dict(e, headers={k: v for k, v in e["headers"].items()
                            if k != "date"})


class _Mock(BaseHTTPRequestHandler):
    ops = {}       # operation id -> polls remaining
    indexes = set()
    uploaded = []

    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _send(self, code, obj=None, headers=None):
        payload = json.dumps(obj).encode() if obj is not None else b""
        self.send_response(code)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):
        body = self._body()
        key = self.headers.get("Ocp-Apim-Subscription-Key")
        path = self.path
        if path.startswith("/vision/ocr"):
            if key != "secret":
                self._send(401, {"error": "bad key"})
                return
            payload = json.loads(body) if body.startswith(b"{") else {}
            self._send(200, {"language": "en",
                             "regions": [{"text": "HELLO"}],
                             "echoUrl": payload.get("url"),
                             "rawBytes": not body.startswith(b"{")})
        elif path.startswith("/vision/recognizeText"):
            op = f"op{len(self.ops)}"
            self.ops[op] = 2  # two "running" polls before success
            host = self.headers.get("Host")
            self._send(202, None,
                       {"Operation-Location": f"http://{host}/vision/op/{op}"})
        elif path.startswith("/vision/analyze"):
            q = path.split("?", 1)[1] if "?" in path else ""
            self._send(200, {"query": q})
        elif path.startswith("/text/sentiment"):
            docs = json.loads(body)["documents"]
            self._send(200, {"documents": [
                {"id": d["id"], "score": 0.9 if "good" in d["text"] else 0.1}
                for d in docs]})
        elif path.startswith("/text/languages"):
            docs = json.loads(body)["documents"]
            self._send(200, {"documents": [
                {"id": d["id"],
                 "detectedLanguages": [{"iso6391Name": "en", "score": 1.0}]}
                for d in docs]})
        elif path.startswith("/face/detect"):
            self._send(200, [{"faceId": "f1",
                              "faceRectangle": {"top": 1, "left": 2}}])
        elif path.startswith("/face/verify"):
            b = json.loads(body)
            s = b.get("faceId1") == b.get("faceId2")
            self._send(200, {"isIdentical": s,
                             "confidence": 1.0 if s else 0.1})
        elif path.startswith("/speech"):
            self._send(200, {"DisplayText": f"{len(body)} bytes heard"})
        elif path.startswith("/anomaly/entire"):
            series = json.loads(body)["series"]
            n = len(series)
            vals = [p["value"] for p in series]
            med = sorted(vals)[n // 2]
            self._send(200, {
                "isAnomaly": [abs(v - med) > 50 for v in vals],
                "expectedValues": [med] * n,
                "upperMargins": [5.0] * n,
                "lowerMargins": [5.0] * n})
        elif path.startswith("/search/indexes") and path.count("/") == 2:
            self.indexes.add(json.loads(body)["name"])
            self._send(201, {"ok": True})
        elif "/docs/index" in path:
            docs = json.loads(body)["value"]
            self.uploaded.extend(docs)
            self._send(200, {"value": [{"status": True} for _ in docs]})
        else:
            self._send(404, {"error": path})

    def do_GET(self):
        path = self.path
        if path.startswith("/vision/op/"):
            op = path.rsplit("/", 1)[1]
            if self.ops.get(op, 0) > 0:
                self.ops[op] -= 1
                self._send(200, {"status": "Running"})
            else:
                self._send(200, {"status": "Succeeded",
                                 "recognitionResult": {"lines": ["done"]}})
        elif path.startswith("/bing/images"):
            q = path.split("q=", 1)[1].split("&")[0] if "q=" in path else ""
            self._send(200, {"value": [
                {"contentUrl": f"http://img/{q}/1"},
                {"contentUrl": f"http://img/{q}/2"}]})
        elif path.startswith("/search/indexes/"):
            name = path.split("/indexes/", 1)[1].split("?")[0]
            self._send(200 if name in self.indexes else 404, {})
        else:
            self._send(404, {"error": path})

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def base():
    httpd = ThreadingHTTPServer(("localhost", 0), _Mock)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    host, port = httpd.server_address[:2]
    yield f"http://{host}:{port}"
    httpd.shutdown()
    httpd.server_close()


def _cols(out, *names):
    return tuple(list(out[n]) for n in names)


def test_ocr_url_and_bytes(base):
    def run(p):
        t = (p.cog.OCR().set_subscription_key("secret")
             .set_url(f"{base}/vision/ocr")
             .set(outputCol="ocr", errorCol="err"))
        t.set_imageUrl_col("url")
        out = t.transform(p.D({"url": ["http://x/1.png", "http://x/2.png"]}))
        t2 = (p.cog.OCR().set_subscription_key("secret")
              .set_url(f"{base}/vision/ocr")
              .set(outputCol="ocr", errorCol="err"))
        t2.set_imageBytes_col("img")
        out2 = t2.transform(p.D({"img": [b"\x89PNGdata"]}))
        return out.columns, _cols(out, "ocr", "err"), _cols(out2, "ocr")
    cols, (ocr, err), (raw,) = same(run)
    assert ocr[0]["regions"][0]["text"] == "HELLO"
    assert ocr[1]["echoUrl"] == "http://x/2.png" and err == [None, None]
    assert raw[0]["rawBytes"] is True


def test_ocr_bad_key_goes_to_error_col(base):
    def run(p):
        t = (p.cog.OCR().set_subscription_key("wrong")
             .set_url(f"{base}/vision/ocr")
             .set(outputCol="ocr", errorCol="err"))
        t.set_imageUrl_col("url")
        out = t.transform(p.D({"url": ["http://x/1.png"]}))
        return list(out["ocr"]), [_err(e) for e in out["err"]]
    ocr, err = same(run)
    assert ocr == [None] and err[0]["statusCode"] == 401


def test_recognize_text_polls_to_completion(base):
    def run(p):
        t = (p.cog.RecognizeText().set_subscription_key("k")
             .set_url(f"{base}/vision/recognizeText")
             .set(outputCol="txt", errorCol="err", pollingDelay=0.01))
        t.set_imageUrl_col("url")
        return list(t.transform(p.D({"url": ["http://x/h.png"]}))["txt"])
    txt = same(run)
    assert txt[0]["status"] == "Succeeded"
    assert txt[0]["recognitionResult"]["lines"] == ["done"]


def test_analyze_image_query_params(base):
    def run(p):
        t = (p.cog.AnalyzeImage().set_subscription_key("k")
             .set_url(f"{base}/vision/analyze")
             .set(outputCol="a", errorCol="err"))
        t.set_imageUrl_col("url")
        t.set_visualFeatures(["Categories", "Tags"])
        return list(t.transform(p.D({"url": ["http://x/a.png"]}))["a"])
    a = same(run)
    assert "visualFeatures=Categories%2CTags" in a[0]["query"]


def test_text_sentiment_per_row_and_static(base):
    def run(p):
        t = (p.cog.TextSentiment().set_subscription_key("k")
             .set_url(f"{base}/text/sentiment")
             .set(outputCol="sent", errorCol="err", concurrency=2))
        t.set_text_col("txt")
        return list(t.transform(p.D({"txt": ["good day", "bad day"]}))[
            "sent"])
    sent = same(run)
    assert [s["documents"][0]["score"] for s in sent] == [0.9, 0.1]


def test_language_detector(base):
    def run(p):
        t = (p.cog.LanguageDetector().set_subscription_key("k")
             .set_url(f"{base}/text/languages")
             .set(outputCol="lang", errorCol="err"))
        t.set_text_col("txt")
        return list(t.transform(p.D({"txt": ["hello world"]}))["lang"])
    lang = same(run)
    assert lang[0]["documents"][0]["detectedLanguages"][0][
        "iso6391Name"] == "en"


def test_face_detect_and_verify(base):
    def run(p):
        t = (p.cog.DetectFace().set_subscription_key("k")
             .set_url(f"{base}/face/detect")
             .set(outputCol="faces", errorCol="err"))
        t.set_imageUrl_col("url")
        t.set_returnFaceId(True)
        faces = list(t.transform(p.D({"url": ["http://x/f.png"]}))["faces"])
        v = (p.cog.VerifyFaces().set_subscription_key("k")
             .set_url(f"{base}/face/verify")
             .set(outputCol="v", errorCol="err"))
        v.set_faceId1_col("a")
        v.set_faceId2_col("b")
        out = v.transform(p.D({"a": ["f1", "f1"], "b": ["f1", "f2"]}))
        return faces, list(out["v"])
    faces, verified = same(run)
    assert faces[0][0]["faceId"] == "f1"
    assert [r["isIdentical"] for r in verified] == [True, False]


def test_speech_to_text(base):
    def run(p):
        t = (p.cog.SpeechToText().set_subscription_key("k")
             .set_url(f"{base}/speech")
             .set(outputCol="stt", errorCol="err"))
        t.set_audioData_col("audio")
        t.set_language("en-US")
        return list(t.transform(p.D({"audio": [b"RIFF" + b"\x00" * 100]}))[
            "stt"])
    assert "bytes heard" in same(run)[0]["DisplayText"]


def test_simple_detect_anomalies_groups(base):
    def run(p):
        ds = p.D({
            "grp": ["a"] * 4 + ["b"] * 3,
            "timestamp": [f"2026-01-0{i+1}T00:00:00Z" for i in range(4)]
            + [f"2026-02-0{i+1}T00:00:00Z" for i in range(3)],
            "value": np.array([1.0, 2.0, 1.5, 500.0, 10.0, 11.0, 10.5]),
        })
        t = (p.cog.SimpleDetectAnomalies().set_subscription_key("k")
             .set_url(f"{base}/anomaly/entire")
             .set(outputCol="anom", errorCol="err", groupbyCol="grp"))
        t.set_granularity("daily")
        out = t.transform(ds)
        return out.columns, list(out["anom"])
    _, anom = same(run)
    assert anom[3]["isAnomaly"] is True and anom[0]["isAnomaly"] is False
    assert all(a["isAnomaly"] is False for a in anom[4:])


def test_bing_image_search_and_url_explode(base):
    def run(p):
        t = (p.cog.BingImageSearch().set_subscription_key("k")
             .set_url(f"{base}/bing/images")
             .set(outputCol="res", errorCol="err"))
        t.set_q_col("query")
        out = t.transform(p.D({"query": ["cats", "dogs"]}))
        return list(p.cog.BingImageSearch.get_urls(out, "res")["imageUrl"])
    assert same(run) == ["http://img/cats/1", "http://img/cats/2",
                         "http://img/dogs/1", "http://img/dogs/2"]


def test_azure_search_writer(base):
    def run(p):
        _Mock.uploaded.clear()
        _Mock.indexes.discard("idx1")
        w = p.cog.AzureSearchWriter(f"{base}/search", "idx1", "key")
        created = w.ensure_index([{"name": "id", "type": "Edm.String",
                                   "key": True}])
        again = w.ensure_index([])
        n = w.write(p.D({"id": ["1", "2", "3"], "score": np.arange(3.0)}))
        return created, again, n, list(_Mock.uploaded)
    created, again, n, uploaded = same(run)
    assert (created, again, n) == (True, False, 3)
    assert uploaded[0]["@search.action"] == "upload"


def test_cognitive_persistence_roundtrip(tmp_path, base):
    """Saved by either package, the stage loads in the port and answers
    as the original does."""
    def make(p):
        t = (p.cog.TextSentiment().set_subscription_key("k")
             .set_url(f"{base}/text/sentiment")
             .set(outputCol="s", errorCol="e"))
        t.set_text_col("txt")
        t.set_language("en")
        return t
    t, j = both(make)
    save_stage(t, str(tmp_path / "t"))
    jsave_stage(j, str(tmp_path / "j"))
    for d in ("t", "j"):
        t2 = load_stage(str(tmp_path / d))
        assert type(t2) is tcog.TextSentiment
        out = t2.transform(Dataset({"txt": ["good stuff"]}))
        assert out["s"][0]["documents"][0]["score"] == 0.9


def test_text_analytics_url_templates():
    names = ("TextSentiment", "TextSentimentV2", "NER", "NERV2",
             "EntityDetector", "EntityDetectorV2", "KeyPhraseExtractor",
             "KeyPhraseExtractorV2", "LanguageDetector", "LanguageDetectorV2")
    urls = same(lambda p: [getattr(p.cog, n)().set_location("eastus")
                           .get_or_default("url") for n in names])
    b = "https://eastus.api.cognitive.microsoft.com/text/analytics"
    assert urls[:6] == [f"{b}/v3.0/sentiment", f"{b}/v2.0/sentiment",
                        f"{b}/v3.0/entities/recognition/general",
                        f"{b}/v2.1/entities", f"{b}/v3.0/entities/linking",
                        f"{b}/v2.0/entities"]


def test_add_documents_stage(base):
    def run(p):
        _Mock.uploaded.clear()
        stage = (p.cog.AddDocuments(indexName="idx", batchSize=2)
                 .set_subscription_key("secret")
                 .set_url(f"{base}/search/indexes/idx/docs/index"
                          "?api-version=2019-05-06"))
        out = stage.transform(p.D({"id": ["1", "2", "3"],
                                   "score": [0.1, 0.2, 0.3]}))
        first = list(_Mock.uploaded)
        _Mock.uploaded.clear()
        stage.transform(p.D({"id": ["9"], "@search.action": ["merge"]}))
        status = np.asarray(out["status"])
        return (status.tolist(), str(status.dtype), first,
                list(_Mock.uploaded))
    status, dtype, first, merged = same(run)
    assert status == [200, 200, 200] and dtype == "int64"
    assert len(first) == 3
    assert all(d["@search.action"] == "upload" for d in first)
    assert merged[0]["@search.action"] == "merge"


def _req(r):
    return (r.url, r.method, r.headers, r.entity)


def test_bing_filters_ride_the_query_string():
    def run(p):
        s = p.cog.BingImageSearch().set(
            url="https://api.example.com/images/search",
            subscriptionKey="k")
        s.set_service_param("q", "cats")
        s._init_service_params()
        return _req(s.build_request({"q": "cats", "aspect": "Wide",
                                     "license": "Public", "mkt": "en-US",
                                     "minWidth": 300}))
    url, method, _, _ = same(run)
    assert "aspect=Wide" in url and "license=Public" in url
    assert "mkt=en-US" in url and "minWidth=300" in url and method == "GET"


def test_text_analytics_v3_query_params():
    def run(p):
        s = p.cog.TextSentiment().set(url="https://ta.example.com/sentiment",
                                      subscriptionKey="k")
        return _req(s.build_request({"text": "hello",
                                     "modelVersion": "2021-01-01",
                                     "showStats": True}))
    url = same(run)[0]
    assert "model-version=2021-01-01" in url and "showStats=true" in url


def test_language_detector_keeps_query_params():
    def run(p):
        s = p.cog.LanguageDetector().set(
            url="https://ta.example.com/languages", subscriptionKey="k")
        return _req(s.build_request({"text": "bonjour",
                                     "modelVersion": "latest"}))
    url, _, _, entity = same(run)
    assert "model-version=latest" in url
    assert json.loads(entity)["documents"] == [{"id": "0",
                                                 "text": "bonjour"}]


def test_verify_faces_modes():
    def run(p):
        s = p.cog.VerifyFaces().set(url="https://face.example.com/verify",
                                    subscriptionKey="k")
        body = json.loads(s.build_request(
            {"faceId": "f1", "personId": "p1",
             "largePersonGroupId": "g1"}).entity)
        with pytest.raises(ValueError, match="face-to-person") as e:
            s.build_request({"faceId1": "a"})
        return body, str(e.value)
    body, _ = same(run)
    assert body == {"faceId": "f1", "personId": "p1",
                    "largePersonGroupId": "g1"}


def test_anomaly_period_in_body():
    def run(p):
        s = p.cog.DetectAnomalies().set(url="https://an.example.com/detect",
                                        subscriptionKey="k")
        return json.loads(s.build_request(
            {"series": [{"timestamp": "t", "value": 1.0}],
             "granularity": "daily", "period": 7}).entity)
    assert same(run)["period"] == 7


def test_explicit_backoffs_accepted():
    def run(p):
        t = p.http.SimpleHTTPTransformer().set(url="https://x.example.com",
                                               backoffs=[50, 100])
        stages = t._pipeline().stages
        return (t.get_or_default("backoffs"),
                [type(s).__name__ for s in stages],
                stages[1].get_or_default("backoffs"))
    assert same(run) == ([50, 100], ["JSONInputParser", "HTTPTransformer",
                                     "JSONOutputParser"], [50, 100])


def test_sdk_profanity_validation():
    def run(p):
        sdk = p.sdk.SpeechToTextSDK().set(url="http://localhost:1/x",
                                          profanity="sideways")
        with pytest.raises(ValueError, match="Masked") as e:
            sdk.transform(p.D({"audio": [np.zeros(4, np.uint8).tobytes()]}))
        return str(e.value)
    same(run)


def test_verify_faces_bad_row_errors_not_aborts():
    def run(p):
        s = (p.cog.VerifyFaces()
             .set(url="http://localhost:1/verify", subscriptionKey="k",
                  outputCol="out", errorCol="err", backoffs=[]))
        s.set_service_param_col("faceId1", "f1")
        s.set_service_param_col("faceId2", "f2")
        out = s.transform(p.D({"f1": ["a", "b"], "f2": [None, "c"]}))
        return (list(out["out"]), out["err"][0],
                out["err"][1]["statusCode"])
    out, err0, status1 = same(run)
    # row 0 is mode-incomplete: no request, an error row; row 1 failed to
    # connect, which lands as a row error too
    assert out == [None, None] and err0 is None and status1 == 0


def test_empty_backoffs_disables_retries(monkeypatch):
    def run(p):
        seen = {}

        def spy(req, backoffs=(100, 500, 1000), timeout=60.0):
            seen["backoffs"] = list(backoffs)
            raise IOError("stop here")

        monkeypatch.setattr(p.http, "advanced_handling", spy)
        client = p.http.HTTPTransformer().set(backoffs=[])._client()
        with pytest.raises(IOError):
            client.handler(p.http.HTTPRequestData(url="http://x.invalid/"))
        return seen.get("backoffs")
    assert same(run) == []


# -- the streaming speech SDK (tests/test_speech_sdk.py) -------------------------


def make_wav(payload: bytes, sample_rate=16000, channels=1, bits=16,
             fmt_tag=1) -> bytes:
    """Minimal RIFF/WAVE container around ``payload`` sample data."""
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, sample_rate,
                      sample_rate * channels * bits // 8,
                      channels * bits // 8, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt \
        + b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(body)) + body


class _Recognizer(BaseHTTPRequestHandler):
    """Chunked-upload recognizer: one NDJSON event per word of the
    payload decoded as UTF-8."""

    chunks_seen = []

    def do_POST(self):
        assert self.headers.get("Transfer-Encoding") == "chunked"
        data, n_chunks = b"", 0
        while True:
            size = int(self.rfile.readline().strip(), 16)
            chunk = self.rfile.read(size)
            self.rfile.readline()
            if size == 0:
                break
            data += chunk
            n_chunks += 1
        type(self).chunks_seen.append(n_chunks)
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        for i, w in enumerate(data.decode("utf-8", "ignore").split()):
            ev = {"RecognitionStatus": "Success", "DisplayText": w,
                  "Offset": i * 1000, "Duration": 1000}
            self.wfile.write(json.dumps(ev).encode() + b"\n")
            self.wfile.flush()

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def speech():
    srv = ThreadingHTTPServer(("localhost", 0), _Recognizer)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://localhost:{srv.server_port}/speech"
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("kwargs,msg", [
    (dict(fmt_tag=3), "PCM"), (dict(channels=2), "single channel"),
    (dict(sample_rate=44100), "samples per second"),
    (dict(bits=8), "bits per sample")])
def test_wav_validation_matches_jax(kwargs, msg):
    def run(p):
        with pytest.raises(p.sdk.AudioStreamFormatError, match=msg) as e:
            p.sdk.WavStream(make_wav(b"x", **kwargs))
        return str(e.value)
    same(run)
    assert same(lambda p: b"".join(p.sdk.WavStream(
        make_wav(b"hello world")).chunks(4))) == b"hello world"


def test_sdk_streaming_and_intermediate_rows(speech, tmp_path):
    def run(p):
        out = p.sdk.SpeechToTextSDK(
            url=speech, audioDataCol="audio", outputCol="text",
            chunkSize=5).transform(p.D({"audio": [make_wav(
                b"the quick brown fox")], "id": np.array([7])}))
        chunks = _Recognizer.chunks_seen[-1]
        rows = p.sdk.SpeechToTextSDK(
            url=speech, audioDataCol="audio", outputCol="ev",
            streamIntermediateResults=True).transform(p.D({
                "audio": [make_wav(b"alpha beta"), make_wav(b"gamma")],
                "rowid": np.array([1, 2])}))
        rec = tmp_path / f"{p.name}.raw"
        src = tmp_path / "in.wav"
        src.write_bytes(make_wav(b"recorded words here"))
        recorded = p.sdk.SpeechToTextSDK(
            url=speech, audioDataCol="audio", outputCol="text",
            recordAudioData=True, recordedFileNameCol="recfile").transform(
                p.D({"audio": [f"file://{src}"], "recfile": [str(rec)]}))
        mp3 = p.sdk.SpeechToTextSDK(
            url=speech, audioDataCol="audio", fileType="mp3",
            outputCol="text").transform(p.D({"audio": [b"fake mp3 words"]}))
        return (list(out["text"]), chunks, list(rows["ev"]),
                np.asarray(rows["rowid"]).tolist(),
                list(recorded["text"]), rec.read_bytes(), list(mp3["text"]))
    text, chunks, ev, rowid, recorded, raw, mp3 = same(run)
    assert [e["DisplayText"] for e in text[0]] == ["the", "quick", "brown",
                                                   "fox"]
    assert chunks >= 4
    assert [e["DisplayText"] for e in ev] == ["alpha", "beta", "gamma"]
    assert rowid == [1, 1, 2] and len(recorded[0]) == 3
    assert raw == b"recorded words here"
    assert [e["DisplayText"] for e in mp3[0]] == ["fake", "mp3", "words"]
