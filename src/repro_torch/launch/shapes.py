"""Input shapes and meta-tensor stand-ins for every (arch x shape).

Port of ``repro.launch.shapes``. The four input shapes:
    train_4k     seq=4096,   global_batch=256   (training)
    prefill_32k  seq=32768,  global_batch=32    (inference-prefill)
    decode_32k   seq=32768,  global_batch=128   (inference-decode: 1 token,
                                                 32k KV cache)
    long_500k    seq=524288, global_batch=1     (long-context decode;
                                                 sub-quadratic archs only)

``input_specs`` returns tensors on the ``meta`` device (shapes and dtypes,
no data, nothing allocated) where the JAX package returns
``ShapeDtypeStruct``s: what the dry-run (``launch/dryrun``) traces a step
on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "ShapeCase", "LONG_OK", "input_specs", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}

# long_500k eligibility: SSM / hybrid / sliding-window only.
LONG_OK = {"rwkv6-3b", "jamba-v0.1-52b", "gemma2-2b"}


def skip_reason(cfg: ModelConfig, case: ShapeCase) -> Optional[str]:
    if case.name == "long_500k" and cfg.name not in LONG_OK:
        if cfg.family == "audio":
            return ("encoder-decoder audio model: a 500k-token decoder "
                    "cache has no audio meaning")
        return ("pure full-attention architecture without a sliding-window "
                "variant; 500k dense KV cache excluded by the brief")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _context_spec(cfg: ModelConfig, batch: int, dtype):
    if cfg.family == "audio":
        return _meta((batch, cfg.encoder_seq, cfg.d_model), dtype)
    if cfg.family == "vlm":
        return _meta((batch, cfg.n_image_tokens, cfg.d_model), dtype)
    return None


def input_specs(cfg: ModelConfig, case: ShapeCase,
                dtype: torch.dtype = torch.bfloat16,
                batch: Optional[int] = None) -> Dict[str, Any]:
    """Meta tensors for one step of the given kind: ``tokens`` /
    ``labels`` (b, s) or ``token`` (b,) int32, the dense ``cache``
    (``transformer.init_cache`` on meta) and the audio / vlm ``context``.
    ``batch`` overrides the case's global batch (the rows one node
    holds)."""
    b = case.global_batch if batch is None else batch
    s = case.seq_len
    tok = torch.int32
    if case.kind == "train":
        out = {"tokens": _meta((b, s), tok), "labels": _meta((b, s), tok)}
    elif case.kind == "prefill":
        out = {"tokens": _meta((b, s), tok),
               "cache": transformer.init_cache(cfg, b, s, dtype, "meta")}
    elif case.kind == "decode":
        out = {"token": _meta((b,), tok),
               "cache": transformer.init_cache(cfg, b, s, dtype, "meta")}
    else:
        raise ValueError(case.kind)
    ctx = _context_spec(cfg, b, dtype)
    if ctx is not None:
        out["context"] = ctx
    return out
