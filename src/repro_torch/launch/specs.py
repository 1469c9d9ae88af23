"""Assigned input shapes × per-arch input specs: the reference's
``launch/specs.py``, with ``(shape, torch.dtype)`` pairs in place of its
``ShapeDtypeStruct`` stand-ins (the form ``models.model.cache_spec`` gives).

40 cells in all: 10 architectures × 4 shapes.  ``decode_*`` / ``long_*``
are one token against a ``seq_len`` cache; ``train_4k`` is a training step;
``prefill_32k`` the prefill.  ``long_500k`` needs sub-quadratic attention:
pure full-attention archs skip it (``cell_supported``).  Nothing is
allocated: the specs are shapes and dtypes only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_spec

Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full attention: O(S^2) attention and a 500k KV "
                       "cache are not servable; skipped per assignment "
                       "(runs for ssm/hybrid)")
    return True, ""


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    """Model inputs of the train and prefill kinds: ``tokens`` (and
    ``labels`` to train) int32; a VLM's text is ``seq_len - num_patches``
    tokens after ``patch_embeds`` (B, P, D) f32, its labels ``seq_len``
    long; an encoder-decoder's ``frames`` (B, enc_seq, D) f32."""
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Spec] = {}
    if cfg.family == "vlm":
        text = s - cfg.num_patches
        batch["tokens"] = ((b, text), torch.int32)
        batch["patch_embeds"] = ((b, cfg.num_patches, cfg.d_model), torch.float32)
        if shape.kind == "train":
            batch["labels"] = ((b, s), torch.int32)
        return batch
    batch["tokens"] = ((b, s), torch.int32)
    if cfg.family == "encdec":
        batch["frames"] = ((b, cfg.enc_seq, cfg.d_model), torch.float32)
    if shape.kind == "train":
        batch["labels"] = ((b, s), torch.int32)
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Spec, Dict[str, Spec]]:
    """(token, cache) specs of the decode kinds: one int32 token per
    sequence, and the cache of ``seq_len`` positions."""
    token = ((shape.global_batch,), torch.int32)
    return token, cache_spec(cfg, shape.global_batch, shape.seq_len)


def input_specs(cfg: ModelConfig, shape_name: str):
    """Every model input of the cell, as specs: ``{"token", "cache"}`` for
    the decode kinds, ``{"batch"}`` otherwise."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        token, cache = decode_specs(cfg, shape)
        return {"token": token, "cache": cache}
    return {"batch": batch_specs(cfg, shape)}
