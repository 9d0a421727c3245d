"""Image Relative Position Encoding (iRPE) for the weight-share students.

Port of ``distillclip_tpu/models/irpe.py``.  The config, its checks and the
bucket tables are the JAX package's, line for line: the tables are host math
in numpy, computed once per (method, grid) and cached, and give the same ids.

The tables are applied in PyTorch's own idiom, the reference's pure-torch
route (``_irpe.py:574-577``, ``:639-643``):

* **keys and queries** (contextual): ``x @ W`` gives ``[B, H, L, buckets]``,
  then ``torch.gather`` by bucket id gives the ``[B, H, L, L]`` encoding;
* **values** (contextual): the probabilities are scatter-added into their
  buckets (``[B, H, L, buckets]``), then multiplied by ``W_v``;
* **bias mode**: a gather of the bias table;
* ``cross``: the sum of its two sub-methods (rows and columns).

The rounding points are JAX's: the lookup ``x @ W`` accumulates in fp32 and is
rounded to the compute dtype before the gather, the contextual encodings are
fp32, and the value encoding is rounded to the compute dtype.

Each table has a leading ``repeats`` axis, one instance per repeat of a
weight-share block, and a sub-method axis: ``rpe_{q,k}_weight`` is ``[R,
n_sub, H', d, buckets]``, ``rpe_{q,k}_bias`` ``[R, n_sub, H', buckets]`` and
``rpe_v_weight`` ``[R, n_sub, H', buckets, d]``, with ``H'`` 1 under
``shared_head``.  They are zero-initialised, so a fresh iRPE tower computes
what the tower without it computes.

Piecewise index function: Eq. (18) of the iRPE paper (``_irpe.py:15-48``).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

METHODS = ("euc", "quant", "cross", "product")
MODES = ("bias", "contextual")


@dataclasses.dataclass(frozen=True)
class RpeConfig:
    """Static iRPE config (reference get_rpe_config, _irpe.py:819-883).

    ``rpe_on`` selects attachment points: any subset of "qkv".
    """

    ratio: float = 1.9
    method: str = "product"
    mode: str = "contextual"
    shared_head: bool = True
    skip: int = 1  # 1 = cls token precedes spatial tokens
    rpe_on: str = "k"

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {self.method}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode}")

    @property
    def alpha(self) -> float:
        return 1.0 * self.ratio

    @property
    def beta(self) -> float:
        return 2.0 * self.ratio

    @property
    def gamma(self) -> float:
        return 8.0 * self.ratio

    def num_buckets(self, method: Optional[str] = None) -> int:
        """Bucket count incl. the skip-token bucket (_irpe.py:256-279,809-816)."""
        method = method or self.method
        beta_int = int(self.beta)
        if method == "product":
            n = (2 * beta_int + 1) ** 2
        else:
            n = 2 * beta_int + 1
        if self.skip > 0:
            n += 1
        return n


def rpe_config_from_dict(d) -> Optional[RpeConfig]:
    """Build an RpeConfig from a YAML dict (None passes through)."""
    if d is None:
        return None
    if isinstance(d, RpeConfig):
        return d
    return RpeConfig(**d)


# -- host-side bucket tables (numpy, cached) ---------------------------------------


def _piecewise_index(rel: np.ndarray, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """np version of the paper's piecewise index fn (_irpe.py:15-48)."""
    rel = rel.astype(np.float64)
    rp_abs = np.abs(rel)
    inner = np.round(rel)
    with np.errstate(divide="ignore", invalid="ignore"):
        log_part = np.log(rp_abs / alpha) / math.log(gamma / alpha) * (beta - alpha)
        outer = np.sign(rel) * np.minimum(np.round(alpha + log_part), beta)
    outer = np.nan_to_num(outer)  # |rel| <= alpha entries use the inner branch anyway
    idx = np.where(rp_abs <= alpha, inner, outer)
    return idx.astype(np.int64)


def _method_bucket_ids(method: str, diff: np.ndarray, alpha, beta, gamma) -> np.ndarray:
    """diff: [L, L, 2] row/col offsets -> bucket ids (before skip handling)."""
    beta_int = int(beta)
    if method == "product":
        S = 2 * beta_int + 1
        r = _piecewise_index(diff[:, :, 0], alpha, beta, gamma) + beta_int
        c = _piecewise_index(diff[:, :, 1], alpha, beta, gamma) + beta_int
        return r * S + c
    if method == "euc":
        dis = np.round(np.sqrt((diff ** 2).sum(2).astype(np.float64)))
        return _piecewise_index(dis, alpha, beta, gamma) + beta_int
    if method == "quant":
        dis = (diff ** 2).sum(2)
        return _piecewise_index(dis, alpha, beta, gamma) + beta_int
    if method == "cross_rows":
        return _piecewise_index(diff[:, :, 0], alpha, beta, gamma) + beta_int
    if method == "cross_cols":
        return _piecewise_index(diff[:, :, 1], alpha, beta, gamma) + beta_int
    raise NotImplementedError(method)


@lru_cache(maxsize=64)
def bucket_ids_2d(
    method: str, height: int, width: int, skip: int, alpha: float, beta: float, gamma: float
) -> Tuple[np.ndarray, int]:
    """[skip+L, skip+L] bucket ids + bucket count (_irpe.py:359-411)."""
    rows = np.arange(height)[:, None].repeat(width, 1)
    cols = np.arange(width)[None, :].repeat(height, 0)
    pos = np.stack([rows, cols], 2).reshape(height * width, 2)
    diff = pos[:, None, :] - pos[None, :, :]
    ids = _method_bucket_ids(method, diff, alpha, beta, gamma)

    beta_int = int(beta)
    if method == "product":
        num = (2 * beta_int + 1) ** 2
    else:
        num = 2 * beta_int + 1

    L = height * width
    if skip > 0:
        out = np.full((skip + L, skip + L), num, dtype=np.int64)
        out[skip:, skip:] = ids
        num += 1
        ids = out
    return ids.astype(np.int32), num


def _grid_hw(seq_len: int, skip: int) -> Tuple[int, int]:
    E = int(math.isqrt(seq_len - skip))
    if E * E != seq_len - skip:
        raise ValueError(f"seq_len {seq_len} minus skip {skip} is not a square grid")
    return E, E


def _sub_methods(method: str):
    return ("cross_rows", "cross_cols") if method == "cross" else (method,)


@lru_cache(maxsize=64)
def _bucket_index(config: RpeConfig, seq_len: int, device: str) -> torch.Tensor:
    h, w = _grid_hw(seq_len, config.skip)
    ids = [bucket_ids_2d(m, h, w, config.skip, config.alpha, config.beta, config.gamma)[0]
           for m in _sub_methods(config.method)]
    return torch.from_numpy(np.stack(ids)).long().to(device)


def bucket_index(config: RpeConfig, seq_len: int, device) -> torch.Tensor:
    """The bucket ids of every sub-method as one ``[n_sub, L, L]`` int64
    tensor on ``device``, made once per (config, length, device).  A length
    that is not ``skip`` plus a square grid raises ``ValueError``."""
    return _bucket_index(config, seq_len, str(torch.device(device)))


# -- the tables and their application --------------------------------------------


def table_shapes(config: RpeConfig, head_dim: int, num_heads: int, repeats: int) -> dict:
    """``{parameter name: shape}`` of the tables an attention module holds
    (build_rpe, _irpe.py:886-927).  Values in bias mode do not exist
    (_irpe.py:486) and raise as in the JAX package."""
    heads = 1 if config.shared_head else num_heads
    nb = config.num_buckets()
    n_sub = len(_sub_methods(config.method))
    shapes = {}
    for which in ("q", "k"):
        if which in config.rpe_on:
            if config.mode == "bias":
                shapes[f"rpe_{which}_bias"] = (repeats, n_sub, heads, nb)
            else:
                shapes[f"rpe_{which}_weight"] = (repeats, n_sub, heads, head_dim, nb)
    if "v" in config.rpe_on:
        if config.mode != "contextual":
            raise NotImplementedError("bias non-transposed RPE does not exist (_irpe.py:486)")
        shapes["rpe_v_weight"] = (repeats, n_sub, heads, nb, head_dim)
    return shapes


@dataclasses.dataclass
class RpeParams:
    """One attention module's tables and the static facts they are applied
    with."""

    config: RpeConfig
    seq_len: int
    num_heads: int
    head_dim: int
    q_table: Optional[torch.Tensor] = None  # [R, n_sub, H', d, nb] or bias [R, n_sub, H', nb]
    k_table: Optional[torch.Tensor] = None
    v_table: Optional[torch.Tensor] = None  # [R, n_sub, H', nb, d]


def _transposed_rpe(params: RpeParams, table: torch.Tensor, repeat_id: int,
                    x: torch.Tensor) -> torch.Tensor:
    """RPE on q or k: x ``[B, H, L, d]`` -> the additive ``[B, H, L, L]``
    encoding.  contextual: ``ret[b,h,i,j] = x[b,h,i] · W[h,:,bucket(i,j)]``
    (fp32); bias: ``ret[h,i,j] = bias[h, bucket(i,j)]`` (x's dtype)."""
    cfg = params.config
    ids = bucket_index(cfg, params.seq_len, x.device)
    B, H, L = x.shape[:3]
    out = None
    for sub, idx in enumerate(ids):
        t = table[repeat_id, sub].to(x.dtype)       # [H', d, nb] or [H', nb]
        if cfg.mode == "bias":
            enc = t[:, idx][None].expand(B, H, L, L)
        else:
            # bf16 products are exact in fp32: the fp32 accumulation of the
            # JAX einsum, then its rounding to the compute dtype.  The gather
            # reads fp32 values, so that its backward sums a bucket's
            # gradients in fp32 and rounds them once, as the JAX contraction's
            # transpose does
            lookup = (x.float() @ t.float()).to(x.dtype).float()   # [B, H, L, nb]
            enc = lookup.gather(-1, idx.expand(B, H, L, L))
        out = enc if out is None else out + enc
    return out


def _no_transpose_rpe(params: RpeParams, table: torch.Tensor, repeat_id: int,
                      attn: torch.Tensor) -> torch.Tensor:
    """RPE on values: attn ``[B, H, L, L]`` -> the ``[B, H, L, d]`` addend
    ``out[b,h,i] = Σ_j attn[b,h,i,j] · W[h, bucket(i,j)]``, summed per bucket
    first, in attn's dtype."""
    ids = bucket_index(params.config, params.seq_len, attn.device)
    B, H, L = attn.shape[:3]
    nb = table.shape[-2]
    src = attn.float()
    out = None
    for sub, idx in enumerate(ids):
        t = table[repeat_id, sub].to(attn.dtype).float()             # [H', nb, d]
        per_bucket = src.new_zeros(B, H, L, nb).scatter_add(-1, idx.expand(B, H, L, L), src)
        enc = (per_bucket @ t).to(attn.dtype)
        out = enc if out is None else out + enc
    return out


def rpe_on_keys(params: RpeParams, repeat_id: int, q: torch.Tensor) -> torch.Tensor:
    """attn += rpe_k(q) (weight_share_model.py:107-108)."""
    if params.k_table is None:
        return q.new_zeros(q.shape[:3] + (q.shape[2],))
    return _transposed_rpe(params, params.k_table, repeat_id, q)


def rpe_on_queries(params: RpeParams, repeat_id: int, k_scaled: torch.Tensor) -> torch.Tensor:
    """attn += rpe_q(k * scale).transpose(2,3) (weight_share_model.py:111-112)."""
    if params.q_table is None:
        return k_scaled.new_zeros(k_scaled.shape[:3] + (k_scaled.shape[2],))
    return _transposed_rpe(params, params.q_table, repeat_id, k_scaled).transpose(2, 3)


def rpe_on_values(params: RpeParams, repeat_id: int, attn: torch.Tensor) -> torch.Tensor:
    """out += rpe_v(attn) (weight_share_model.py:128-129)."""
    if params.v_table is None:
        return attn.new_zeros(attn.shape[:3] + (params.head_dim,))
    return _no_transpose_rpe(params, params.v_table, repeat_id, attn)
