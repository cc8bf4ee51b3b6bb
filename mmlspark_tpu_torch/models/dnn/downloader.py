"""ModelDownloader: pretrained-model repository with hash check + retries.

Counterpart of ``mmlspark_tpu/models/dnn/downloader.py`` (reference:
downloader/ModelDownloader.scala:37-276 — fetch CNTK models from the Azure
blob repo with sha-hash verification and FaultToleranceUtils
retry-with-timeout; downloader/Schema.scala:30 ``ModelSchema`` with
layerNames). A model is a param tree + an architecture config; sources are
``file://`` paths, ``http(s)://`` URLs (fetched through the port's
``io/http.py`` ``advanced_handling``; the bytes must be npz), ``package://``
fixtures shipped with the port, and a
*builtin* registry of seeded architectures, so the framework is usable with
zero egress — materialising a builtin is the "download" and lands in the
same local repository with the same hash bookkeeping.

The repository format is the JAX package's, byte for byte: an ``.npz``
payload of the flattened param tree in the JAX layout (convolutions ``[kh,
kw, in, out]``; ``convert.py``), a ``config_json`` entry, ``schema.json``
and sha256 bookkeeping, so a repository written by either package loads in
the other. A builtin is drawn under the JAX package's key,
``PRNGKey(int(sha256(name)[:8], 16))``, with its ``jax.random`` stream
(``utils/prng.py``), so a fresh builtin has the JAX package's weights
(within a few f32 ulps: the normals' ``erf_inv`` tail), and a payload
already in a repository loads to the same weights in both.

Genuinely pretrained weights enter via ``import_torch_resnet``
(torchvision-format state_dict -> folded-BN tree -> repository payload) or
``save_model`` from any param tree.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List

import numpy as np

from ...utils import prng
from .convert import params_from_jax, params_to_jax


@dataclass
class ModelSchema:
    """downloader/Schema.scala:30 parity."""

    name: str
    dataset: str = ""
    modelType: str = "image"
    uri: str = ""
    sha256: str = ""
    inputDims: List[int] = field(default_factory=lambda: [224, 224, 3])
    numLayers: int = 0
    layerNames: List[str] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)


def retry_with_timeout(fn, retries: int = 3, backoff: float = 0.5):
    """FaultToleranceUtils.retryWithTimeout parity
    (downloader/ModelDownloader.scala:37-53)."""
    last = None
    for attempt in range(retries):
        try:
            return fn()
        except Exception as e:
            last = e
            if attempt < retries - 1:
                time.sleep(backoff * (2 ** attempt))
    raise last


# the featurizer catalog the reference fetches from its Azure repo
# (downloader/ModelDownloader.scala:37-276: AlexNet + the ResNet family);
# builtin weights are deterministic inits — real weights come in through
# import_torch_resnet / save_model / file:// payloads.
_BUILTIN: Dict[str, Dict[str, Any]] = {
    "ResNet18": dict(arch="resnet", stage_sizes=(2, 2, 2, 2), width=64,
                     block="basic", num_classes=1000, input_hw=(224, 224)),
    "ResNet34": dict(arch="resnet", stage_sizes=(3, 4, 6, 3), width=64,
                     block="basic", num_classes=1000, input_hw=(224, 224)),
    "ResNet50": dict(arch="resnet", stage_sizes=(3, 4, 6, 3), width=64,
                     block="bottleneck", num_classes=1000,
                     input_hw=(224, 224)),
    "ResNet101": dict(arch="resnet", stage_sizes=(3, 4, 23, 3), width=64,
                      block="bottleneck", num_classes=1000,
                      input_hw=(224, 224)),
    "ResNet152": dict(arch="resnet", stage_sizes=(3, 8, 36, 3), width=64,
                      block="bottleneck", num_classes=1000,
                      input_hw=(224, 224)),
    "AlexNet": dict(arch="alexnet", num_classes=1000, input_hw=(224, 224),
                    width_mult=1.0),
    # small variants for tests / CI
    "ResNet18Tiny": dict(arch="resnet", stage_sizes=(2, 2, 2, 2), width=16,
                         block="basic", num_classes=1000,
                         input_hw=(224, 224)),
    "ResNet50Tiny": dict(arch="resnet", stage_sizes=(1, 1, 1, 1), width=8,
                         block="bottleneck", num_classes=10,
                         input_hw=(64, 64)),
    "ResNet10Micro": dict(arch="resnet", stage_sizes=(1, 1, 1, 1), width=8,
                          block="basic", num_classes=1000,
                          input_hw=(64, 64)),
    "AlexNetTiny": dict(arch="alexnet", num_classes=10, input_hw=(64, 64),
                        width_mult=0.0625),
    "ConvNetMNIST": dict(arch="resnet", stage_sizes=(1, 1), width=8,
                         block="basic", num_classes=10, input_hw=(28, 28)),
}

# genuinely TRAINED checkpoints shipped as package fixtures (zero-egress
# stand-in for the reference's Azure blob repo of trained CNTK models);
# sha256 is pinned at training time (tools/train_digits_fixture.py), so a
# corrupted or tampered fixture fails the same hash check a remote fetch
# would (downloader/ModelDownloader.scala:37-276)
_TRAINED_FIXTURES: Dict[str, Dict[str, Any]] = {
    "DigitsConvNet": dict(
        file="digits_convnet.npz", dataset="sklearn-digits (trained, "
        "~0.97 held-out accuracy — tools/train_digits_fixture.py)",
        sha256="6e812a1fb56bd4b603deec27abc49c8d7010bca5ce56909fc5bb0cb2"
               "c7c5e5b4",
        spec=dict(arch="resnet", stage_sizes=(1, 1), width=8, block="basic",
                  num_classes=10, input_hw=(32, 32))),
}


# the trained checkpoints shipped with the port (package:// URIs)
FIXTURES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")


def _layer_names(spec: Dict[str, Any]) -> List[str]:
    if spec["arch"] == "alexnet":
        return [f"conv{i}" for i in range(1, 6)] + ["fc6", "fc7", "logits"]
    return (["stem"]
            + [f"stage{s}_block{b}"
               for s, nb in enumerate(spec["stage_sizes"])
               for b in range(nb)] + ["pool", "logits"])


def _num_layers(spec: Dict[str, Any]) -> int:
    if spec["arch"] == "alexnet":
        return 8
    from .cnn import BLOCK_SPECS
    per_block = BLOCK_SPECS[spec["block"]]["convs"]
    return per_block * sum(spec["stage_sizes"]) + 2


# -- payload (de)serialization ----------------------------------------------


def _flatten(tree: Dict[str, Any], prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def serialize_payload(params: Dict[str, Any], config: Dict[str, Any]) -> bytes:
    """npz payload: flattened param pytree + a JSON config entry."""
    arrays = _flatten(params, "param/")
    arrays["config_json"] = np.frombuffer(
        json.dumps(config).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def deserialize_payload(data: bytes,
                        allow_pickle: bool = True) -> Dict[str, Any]:
    """Parse a model payload. ``allow_pickle=False`` (mandatory for bytes
    fetched from remote sources) accepts only the npz format — pickle is
    arbitrary code execution on attacker-controlled data. The pickle branch
    exists solely for pre-npz payloads already sitting in local repos."""
    if data[:2] == b"PK":              # npz (zip magic) — the safe format
        z = np.load(io.BytesIO(data), allow_pickle=False)
        config = json.loads(bytes(z["config_json"]).decode())
        params = _unflatten({k[len("param/"):]: z[k] for k in z.files
                             if k.startswith("param/")})
        return {"params": params, "config": config}
    if not allow_pickle:
        raise IOError("remote model payload is not npz-format; refusing to "
                      "unpickle bytes from a remote source")
    return pickle.loads(data)          # legacy local repos


class ModelDownloader:
    """Local model repository (``repo_dir``) + remote/builtin sources."""

    def __init__(self, repo_dir: str):
        self.repo_dir = repo_dir
        os.makedirs(repo_dir, exist_ok=True)

    # -- listing ------------------------------------------------------------
    def local_models(self) -> List[ModelSchema]:
        out = []
        for name in sorted(os.listdir(self.repo_dir)):
            meta = os.path.join(self.repo_dir, name, "schema.json")
            if os.path.exists(meta):
                with open(meta) as f:
                    out.append(ModelSchema(**json.load(f)))
        return out

    def remote_models(self) -> List[ModelSchema]:
        """The builtin catalog (the Azure-blob listing analog): trained
        package fixtures first, then the deterministic-init architectures."""
        trained = [ModelSchema(name=n, modelType="image",
                               dataset=t["dataset"],
                               uri=f"package://{t['file']}",
                               sha256=t["sha256"],
                               inputDims=[*t["spec"]["input_hw"], 3],
                               numLayers=_num_layers(t["spec"]),
                               layerNames=_layer_names(t["spec"]))
                   for n, t in _TRAINED_FIXTURES.items()]
        return trained + [ModelSchema(name=n, modelType="image",
                                      uri=f"builtin://{n}",
                                      inputDims=[*spec["input_hw"], 3],
                                      numLayers=_num_layers(spec),
                                      layerNames=_layer_names(spec))
                          for n, spec in _BUILTIN.items()]

    # -- fetching -----------------------------------------------------------
    def download_model(self, schema_or_name) -> ModelSchema:
        schema = (self._builtin_schema(schema_or_name)
                  if isinstance(schema_or_name, str) else schema_or_name)
        target = os.path.join(self.repo_dir, schema.name)
        payload = os.path.join(target, "model.pkl")
        if os.path.exists(payload) and self._hash_ok(payload, schema.sha256):
            return self._read_schema(schema.name)
        os.makedirs(target, exist_ok=True)
        data = retry_with_timeout(lambda: self._fetch(schema))
        if schema.uri.startswith(("http://", "https://")):
            # validate BEFORE persisting: remote bytes must be npz (a local
            # pickle file would otherwise execute on the next load_model)
            deserialize_payload(data, allow_pickle=False)
        digest = hashlib.sha256(data).hexdigest()
        if schema.sha256 and digest != schema.sha256:
            raise IOError(f"hash mismatch for {schema.name}: "
                          f"{digest} != {schema.sha256}")
        with open(payload, "wb") as f:
            f.write(data)
        schema.sha256 = digest
        with open(os.path.join(target, "schema.json"), "w") as f:
            f.write(schema.to_json())
        return schema

    def save_model(self, name: str, params: Dict[str, Any],
                   config: Dict[str, Any]) -> ModelSchema:
        """Install a param tree (the port's tensors, or numpy arrays in the
        JAX layout — e.g. converted pretrained weights) into the
        repository as an npz payload."""
        data = serialize_payload(params_to_jax(params), config)
        target = os.path.join(self.repo_dir, name)
        os.makedirs(target, exist_ok=True)
        with open(os.path.join(target, "model.pkl"), "wb") as f:
            f.write(data)
        schema = ModelSchema(
            name=name, modelType="image", uri=f"local://{name}",
            sha256=hashlib.sha256(data).hexdigest(),
            inputDims=[*config.get("input_hw", (224, 224)), 3])
        with open(os.path.join(target, "schema.json"), "w") as f:
            f.write(schema.to_json())
        return schema

    def import_torch_resnet(self, name: str, state_dict: Dict[str, Any],
                            arch_name: str = "ResNet50") -> ModelSchema:
        """Install genuinely pretrained weights from a torchvision-format
        ``resnet*`` state_dict (numpy or torch tensors); batch-norm running
        stats are folded for inference (the trained-model ingestion the
        reference does by downloading CNTK models —
        downloader/ModelDownloader.scala:37-276)."""
        from .cnn import CNNConfig, from_torch_resnet_state_dict

        spec = dict(_BUILTIN[arch_name])
        sd = dict(state_dict)
        cfg = CNNConfig(num_classes=int(sd["fc.bias"].shape[0]),
                        stage_sizes=spec["stage_sizes"], width=spec["width"],
                        block=spec["block"], input_hw=spec["input_hw"])
        params = from_torch_resnet_state_dict(sd, cfg)
        config = dict(arch="resnet", num_classes=cfg.num_classes,
                      stage_sizes=cfg.stage_sizes, width=cfg.width,
                      block=cfg.block, input_hw=cfg.input_hw)
        return self.save_model(name, params, config)

    def load_model(self, name: str):
        """-> (params, cfg, apply_fn) ready for DNNModel: the port's param
        tree (CPU tensors), its config and an apply on tensors."""
        payload = os.path.join(self.repo_dir, name, "model.pkl")
        if not os.path.exists(payload):
            self.download_model(name)
        with open(payload, "rb") as f:
            d = deserialize_payload(f.read())
        config = dict(d["config"])
        arch = config.pop("arch", "resnet")
        if arch == "alexnet":
            from .cnn import AlexNetConfig, apply_alexnet
            config["input_hw"] = tuple(config["input_hw"])
            cfg = AlexNetConfig(**config)
            apply_fn = lambda p, x, capture=(): apply_alexnet(  # noqa: E731
                p, x, cfg, capture)
        else:
            from .cnn import CNNConfig, apply_cnn
            config["stage_sizes"] = tuple(config["stage_sizes"])
            config["input_hw"] = tuple(config["input_hw"])
            cfg = CNNConfig(**config)
            apply_fn = lambda p, x, capture=(): apply_cnn(  # noqa: E731
                p, x, cfg, capture)
        return params_from_jax(d["params"]), cfg, apply_fn

    # -- internals ----------------------------------------------------------
    def _builtin_schema(self, name: str) -> ModelSchema:
        for s in self.remote_models():
            if s.name == name:
                return s
        raise KeyError(
            f"unknown model {name!r}; catalog: "
            f"{sorted(_TRAINED_FIXTURES) + sorted(_BUILTIN)}")

    def _read_schema(self, name: str) -> ModelSchema:
        with open(os.path.join(self.repo_dir, name, "schema.json")) as f:
            return ModelSchema(**json.load(f))

    def _hash_ok(self, path: str, expected: str) -> bool:
        if not expected:
            return True
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest() == expected

    def _fetch(self, schema: ModelSchema) -> bytes:
        uri = schema.uri
        if uri.startswith("package://"):
            path = os.path.join(FIXTURES_DIR, uri[len("package://"):])
            with open(path, "rb") as f:
                return f.read()
        if uri.startswith("builtin://"):
            return self._materialize_builtin(uri[len("builtin://"):])
        if uri.startswith("file://"):
            with open(uri[len("file://"):], "rb") as f:
                return f.read()
        if uri.startswith(("http://", "https://")):
            from ...io.http import HTTPRequestData, advanced_handling
            resp = advanced_handling(HTTPRequestData(url=uri), timeout=120.0)
            if not (200 <= resp.status_code < 300):
                raise IOError(f"fetch failed: {resp.status_code} {resp.reason}")
            return resp.entity or b""
        raise ValueError(f"unsupported model uri {uri!r}")

    def _materialize_builtin(self, name: str) -> bytes:
        spec = dict(_BUILTIN[name])
        arch = spec.pop("arch")
        # the JAX package's key, from the name's hash
        key = prng.prng_key(
            int(hashlib.sha256(name.encode()).hexdigest()[:8], 16))
        if arch == "alexnet":
            from .cnn import AlexNetConfig, init_alexnet_params
            cfg = AlexNetConfig(**spec)
            params = init_alexnet_params(cfg, key)
        else:
            from .cnn import CNNConfig, init_cnn_params
            cfg = CNNConfig(**spec)
            params = init_cnn_params(cfg, key)
        return serialize_payload(params_to_jax(params),
                                 {"arch": arch, **spec})
