"""Shared helpers of the LM training parity tests (``test_torch_train*``,
``test_torch_forward``, ``test_torch_crossattn``): one reference model per
(arch, mode, dtype) carried into the port, and numpy batches given to both
packages in one dtype."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import layers as tlayers

B, S = 2, 16


def rel(got, want) -> float:
    """max |got − want| over the largest |want|."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def both(a, dtype=np.float32):
    """One numpy array as (jax, torch) in ``dtype`` (float32 or "bf16")."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), \
            torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a)


def cfgs(name, mode="fused", bf16=False):
    """The smoke config of ``name`` in both packages, PTC k = 8 in
    ``mode`` with fp32 (or bf16) bases."""
    jc, tc = jsmoke_config(name), smoke_config(name)
    jb = jnp.bfloat16 if bf16 else jnp.float32
    tb = torch.bfloat16 if bf16 else torch.float32
    return (dataclasses.replace(jc, ptc=jlayers.PTCLinearCfg(
                k=8, mode=mode, base_dtype=jb)),
            dataclasses.replace(tc, ptc=tlayers.PTCLinearCfg(
                k=8, mode=mode, base_dtype=tb)))


@functools.lru_cache(maxsize=None)
def model(name, mode="fused", bf16=False, seed=0):
    """(reference cfg, port cfg, reference params, port params): the
    reference's seeded init carried over by ``convert``."""
    jc, tc = cfgs(name, mode, bf16)
    jp = jlm.init_model(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, convert.lm_params(jp)


def lm_inputs(cfg, seed=0, batch=B, seq=S, img=None, frames=None):
    """Token / label batch of ``cfg``'s vocab, plus encdec frames (B,
    S_enc, d) or vlm image tokens (B, n_img, d) of scale 0.5, as numpy."""
    rng = np.random.default_rng(seed)
    raw = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)),
           "labels": rng.integers(0, cfg.vocab, (batch, seq))}
    raw = {k: v.astype(np.int32) for k, v in raw.items()}
    if cfg.family == "encdec":
        raw["frames"] = 0.5 * rng.normal(size=(batch, frames or seq,
                                               cfg.d_model))
    if cfg.family == "vlm":
        raw["img"] = 0.5 * rng.normal(size=(batch, img or cfg.n_img_tokens,
                                            cfg.d_model))
    return raw


def split_batch(raw, bf16=False):
    """(reference batch, port batch) from numpy: integer arrays as they
    are, float modality inputs in float32 (or bf16)."""
    jb, tb = {}, {}
    for k, v in raw.items():
        if v.dtype.kind == "i":
            jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(v)
        else:
            jb[k], tb[k] = both(v, "bf16" if bf16 else np.float32)
    return jb, tb


def leaves(tree):
    """A port tree's leaves in sorted key order (``jax.tree``'s order)."""
    for _, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def at(tree, path):
    """The port tree's entry at a ``jax.tree_util`` key path."""
    for e in path:
        tree = tree[e.key]
    return tree
