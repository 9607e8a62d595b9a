"""Weight-only export and import of a trained dictionary (the port's copy of
sparse_vision_tpu/train/sae_io.py).

- Native format: an ``.npz`` of the parameter dict in the math layout (W_enc
  [d, h], W_dec [h, d]); the JAX package writes and reads the same files.
- Torch ``.pth``: the reference's ``nn.Linear`` keys (``encoder.weight`` [h, d],
  ``decoder.weight`` [d, h]; the gated SAE's ``W_gate`` [h, d]; a crosscoder's
  ``encoder_{i}`` / ``decoder_{i}``), and on import also the legacy ``W_enc`` /
  ``W_dec`` keys, which are stored in the math layout already.
- SAELens: a folder of ``cfg.json`` and ``sae_weights.safetensors``. SAELens
  keeps W_enc [d_in, d_sae] and W_dec [d_sae, d_in], the math layout; the gated
  SAE's gate weight is its ``W_enc`` and JumpReLU's threshold is stored linear.
  A BatchTopK SAE publishes as a JumpReLU SAE (its deployment form) with its
  scalar threshold on every latent; sae_conv has no SAELens form.
  The safetensors file is written and read here (an 8-byte little-endian header
  length, a JSON header of ``dtype``, ``shape`` and ``data_offsets`` per tensor,
  then the raw little-endian bytes), so no safetensors package is needed.

Loaders return a dict of CPU tensors.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

# native parameter keys per SAE variant (models/sae.py init_* functions)
_NATIVE_KEYS = {
    "sae_mlp": ("W_enc", "b_enc", "W_dec", "b_dec"),
    "gated_sae": ("W_gate", "b_gate", "b_mag", "r_mag", "W_dec", "b_dec"),
    "jumprelu_sae": ("W_enc", "b_enc", "W_dec", "b_dec", "log_threshold"),
    "topk_sae": ("W_enc", "b_enc", "W_dec", "b_dec"),
    "batch_topk_sae": ("W_enc", "b_enc", "W_dec", "b_dec", "threshold"),
    "matryoshka_sae": ("W_enc", "b_enc", "W_dec", "b_dec"),
}
# the optional keys of an import: ReLU weights may load into these variants
_THRESHOLDS = {"jumprelu_sae": "log_threshold", "batch_topk_sae": "threshold"}


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _c(a) -> np.ndarray:
    """``a`` C-contiguous, its shape kept (np.ascontiguousarray makes a 0-d
    array 1-d)."""
    a = np.asarray(a)
    return a if a.flags.c_contiguous else a.copy(order="C")


def _tensors(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}  # writable copies


def save_sae_weights(params: dict, folder: str, file_name: str = "model_weights") -> str:
    """Weight-only save to ``<folder>/<file_name>.npz`` (temp file, then
    os.replace)."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"{file_name}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: _np(v) for k, v in params.items()})
    os.replace(tmp, path)
    return path


def to_torch_state_dict(params: dict, sae_model_name: str) -> dict:
    """Native parameter dict -> the reference's ``nn.Linear`` key layout, as
    contiguous CPU tensors."""
    p = {k: _np(v) for k, v in params.items()}
    if sae_model_name == "crosscoder":
        out = {"b_enc": p["b_enc"]}
        n = sum(1 for k in p if k.startswith("W_enc_"))
        for i in range(n):
            out[f"encoder_{i}.weight"] = p[f"W_enc_{i}"].T  # [h, d_i]
            out[f"decoder_{i}.weight"] = p[f"W_dec_{i}"].T  # [d_i, h]
            out[f"decoder_{i}.bias"] = p[f"b_dec_{i}"]
    elif sae_model_name == "gated_sae":
        out = {
            "W_gate": p["W_gate"].T,  # [h, d]
            "b_gate": p["b_gate"],
            "b_mag": p["b_mag"],
            "r_mag": p["r_mag"],
            "decoder.weight": p["W_dec"].T,  # nn.Linear(h, d): [d, h]
            "decoder.bias": p["b_dec"],
        }
    else:
        out = {
            "encoder.weight": p["W_enc"].T,  # nn.Linear(d, h): [h, d]
            "encoder.bias": p["b_enc"],
            "decoder.weight": p["W_dec"].T,
            "decoder.bias": p["b_dec"],
        }
        thr = _THRESHOLDS.get(sae_model_name)
        if thr in p:
            out[thr] = p[thr]
    return {k: torch.from_numpy(_c(v)) for k, v in out.items()}


def _normalize_state_dict(sd: dict, sae_model_name: str) -> dict:
    """A torch state dict in either key convention -> the native layout (numpy)."""
    sd = {k: _np(v) for k, v in sd.items()}
    out: dict = {}
    if sae_model_name == "crosscoder":
        out["b_enc"] = sd["b_enc"]
        n = sum(1 for k in sd if k.startswith("encoder_") and k.endswith(".weight"))
        for i in range(n):
            out[f"W_enc_{i}"] = sd[f"encoder_{i}.weight"].T
            out[f"W_dec_{i}"] = sd[f"decoder_{i}.weight"].T
            out[f"b_dec_{i}"] = sd[f"decoder_{i}.bias"]
        return out
    if sae_model_name == "gated_sae":
        out["W_gate"] = sd["W_gate"].T  # [h, d] -> [d, h]
        out["b_gate"] = sd["b_gate"]
        out["b_mag"] = sd["b_mag"]
        out["r_mag"] = sd["r_mag"]
    else:
        if "encoder.weight" in sd:  # nn.Linear convention
            out["W_enc"] = sd["encoder.weight"].T
            out["b_enc"] = sd["encoder.bias"]
        else:  # legacy W_enc convention: stored [d, h], native already
            out["W_enc"] = sd["W_enc"]
            out["b_enc"] = sd["b_enc"]
        thr = _THRESHOLDS.get(sae_model_name)
        if thr in sd:
            out[thr] = sd[thr]
    if "decoder.weight" in sd:
        out["W_dec"] = sd["decoder.weight"].T
        out["b_dec"] = sd["decoder.bias"]
    else:  # legacy: stored W_dec is [h, d], native already
        out["W_dec"] = sd["W_dec"]
        out["b_dec"] = sd["b_dec"]
    return out


# ---------------------------------------------------------------------------
# the safetensors file format
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}
_ST_CODES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def save_safetensors(tensors: dict, path: str, metadata: dict | None = None) -> str:
    """Write numpy arrays as a safetensors file: the header's entries in name
    order, their bytes back to back in the same order, the header padded with
    spaces to a multiple of 8 bytes."""
    header: dict = {"__metadata__": metadata} if metadata else {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        a = _c(tensors[name])
        if a.dtype not in _ST_CODES:
            raise TypeError(f"safetensors: no dtype code for {name!r} ({a.dtype})")
        data = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _ST_CODES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
    return path


def load_safetensors(path: str) -> dict:
    """Read a safetensors file into numpy arrays, checking that the header's
    offsets tile the data section."""
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    header.pop("__metadata__", None)
    out, ends = {}, []
    for name, e in header.items():
        begin, end = e["data_offsets"]
        dtype = np.dtype(_ST_DTYPES[e["dtype"]]).newbyteorder("<")
        shape = tuple(e["shape"])
        if end - begin != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name!r} has {end - begin} bytes for {shape} {dtype}")
        out[name] = np.frombuffer(data[begin:end], dtype=dtype).reshape(shape).astype(
            dtype.newbyteorder("="))
        ends.append((begin, end))
    pos = 0
    for begin, end in sorted(ends):
        if begin != pos:
            raise ValueError(f"{path}: tensor data is not contiguous at byte {begin}")
        pos = end
    if pos != len(data):
        raise ValueError(f"{path}: {len(data) - pos} trailing bytes after the tensors")
    return out


# ---------------------------------------------------------------------------
# SAELens
# ---------------------------------------------------------------------------

# variant names <-> SAELens cfg.json "architecture" values
_SAELENS_ARCH = {
    "sae_mlp": "standard",
    "gated_sae": "gated",
    "jumprelu_sae": "jumprelu",
    "topk_sae": "topk",
    # the BatchTopK -> JumpReLU conversion: its exact inference form
    "batch_topk_sae": "jumprelu",
    "matryoshka_sae": "standard",  # the nesting lives in the loss
}
_ARCH_TO_NATIVE = {"standard": "sae_mlp", "gated": "gated_sae",
                   "jumprelu": "jumprelu_sae", "topk": "topk_sae"}
SAELENS_WEIGHTS_FILE = "sae_weights.safetensors"
SAELENS_CFG_FILE = "cfg.json"


def _to_saelens_tensors(params: dict, sae_model_name: str) -> dict:
    p = {k: _np(v) for k, v in params.items()}
    if sae_model_name == "gated_sae":
        return {"W_enc": p["W_gate"], "b_gate": p["b_gate"],
                "b_mag": p["b_mag"], "r_mag": p["r_mag"],
                "W_dec": p["W_dec"], "b_dec": p["b_dec"]}
    out = {"W_enc": p["W_enc"], "b_enc": p["b_enc"],
           "W_dec": p["W_dec"], "b_dec": p["b_dec"]}
    if sae_model_name == "jumprelu_sae":
        out["threshold"] = np.exp(p["log_threshold"])
    if sae_model_name == "batch_topk_sae":
        h = p["b_enc"].shape[0]
        out["threshold"] = np.full((h,), p["threshold"], p["threshold"].dtype)
    return out


def _from_saelens_tensors(tensors: dict, sae_model_name: str) -> dict:
    t = {k: np.asarray(v) for k, v in tensors.items()}
    if sae_model_name == "gated_sae":
        return {"W_gate": t["W_enc"], "b_gate": t["b_gate"],
                "b_mag": t["b_mag"], "r_mag": t["r_mag"],
                "W_dec": t["W_dec"], "b_dec": t["b_dec"]}
    out = {"W_enc": t["W_enc"], "b_enc": t["b_enc"],
           "W_dec": t["W_dec"], "b_dec": t["b_dec"]}
    if sae_model_name == "jumprelu_sae" and "threshold" in t:
        thr = t["threshold"]
        if np.any(thr <= 0):
            raise ValueError("SAELens jumprelu threshold must be positive to "
                             "map into log_threshold")
        out["log_threshold"] = np.log(thr)
    if sae_model_name == "batch_topk_sae" and "threshold" in t:
        thr = t["threshold"]
        # a published JumpReLU threshold is per latent; batch_topk's is one scalar
        if thr.ndim and not np.all(thr == thr.flat[0]):
            raise ValueError("per-latent SAELens thresholds differ; load as jumprelu_sae "
                             "instead of batch_topk_sae")
        out["threshold"] = np.asarray(thr.flat[0] if thr.ndim else thr)
    return out


def save_sae_saelens(params: dict, sae_model_name: str, folder: str,
                     extra_cfg: dict | None = None) -> str:
    """Export to ``<folder>/cfg.json`` + ``<folder>/sae_weights.safetensors``;
    returns the folder."""
    if sae_model_name not in _SAELENS_ARCH:
        raise ValueError(f"no SAELens mapping for {sae_model_name!r}")
    tensors = _to_saelens_tensors(params, sae_model_name)
    os.makedirs(folder, exist_ok=True)
    d_in, d_sae = (int(tensors["W_dec"].shape[1]), int(tensors["W_dec"].shape[0]))
    cfg = {
        "architecture": _SAELENS_ARCH[sae_model_name],
        "d_in": d_in,
        "d_sae": d_sae,
        "dtype": str(tensors["W_dec"].dtype),
        "apply_b_dec_to_input": True,  # every variant centres its input on b_dec
        **(extra_cfg or {}),
    }
    wpath = os.path.join(folder, SAELENS_WEIGHTS_FILE)
    save_safetensors(tensors, wpath + ".tmp")
    os.replace(wpath + ".tmp", wpath)
    cpath = os.path.join(folder, SAELENS_CFG_FILE)
    with open(cpath + ".tmp", "w") as f:
        json.dump(cfg, f, indent=1)
    os.replace(cpath + ".tmp", cpath)
    return folder


def load_sae_saelens(path: str, sae_model_name: str | None = None) -> tuple:
    """A SAELens folder (or a bare .safetensors file) -> ``(params, cfg)``; the
    variant comes from cfg.json's "architecture" unless given."""
    cfg: dict = {}
    if os.path.isdir(path):
        cpath = os.path.join(path, SAELENS_CFG_FILE)
        if os.path.exists(cpath):
            with open(cpath) as f:
                cfg = json.load(f)
        path = os.path.join(path, SAELENS_WEIGHTS_FILE)
    if sae_model_name is None:
        arch = cfg.get("architecture", "standard")
        if arch not in _ARCH_TO_NATIVE:
            raise ValueError(f"unknown SAELens architecture {arch!r}")
        sae_model_name = _ARCH_TO_NATIVE[arch]
    return _tensors(_from_saelens_tensors(load_safetensors(path), sae_model_name)), cfg


def load_sae_weights(path: str, sae_model_name: str = "sae_mlp") -> dict:
    """Weights from a native ``.npz``, a torch ``.pth``/``.pt`` state dict, or a
    SAELens ``.safetensors`` file or folder, as the native parameter dict."""
    if path.endswith(".safetensors") or (
        os.path.isdir(path) and os.path.exists(os.path.join(path, SAELENS_WEIGHTS_FILE))
    ):
        return load_sae_saelens(path, sae_model_name)[0]
    if path.endswith(".npz"):
        with np.load(path) as z:
            raw = {k: z[k] for k in z.files}
        # the threshold is optional when importing ReLU weights
        missing = set(_NATIVE_KEYS.get(sae_model_name, ())) - set(raw) - set(
            _THRESHOLDS.values())
        if missing:
            raise KeyError(f"{path} missing native keys {sorted(missing)}")
        return _tensors(raw)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return _tensors(_normalize_state_dict(sd, sae_model_name))


def validate_shapes(params: dict, like: dict, path: str = "") -> None:
    """Raise if an imported dict lacks a key of ``like`` or differs in a shape."""
    for k, v in like.items():
        if k not in params:
            raise KeyError(f"imported weights{f' ({path})' if path else ''} missing {k!r}")
        if tuple(params[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k!r}: imported {tuple(params[k].shape)} "
                             f"vs expected {tuple(v.shape)}")


def import_any(path: str, sae_model_name: str, like: dict) -> dict:
    """Load and validate against a freshly initialized parameter dict (the
    Pipeline's ``sae_weights_path``)."""
    params = load_sae_weights(path, sae_model_name)
    # ReLU weights imported into JumpReLU or BatchTopK keep the initial thresholds
    thr = _THRESHOLDS.get(sae_model_name)
    if thr is not None and thr not in params:
        params[thr] = like[thr].detach().cpu().clone()
    validate_shapes(params, like, path)
    return params
