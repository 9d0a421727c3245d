"""GPU kernel oracle: every hand-written kernel of the port against its plain
PyTorch version, at the shapes the main paths give it.

Interpret mode and CPU runs do not prove a kernel: a kernel can agree on the
CPU path and be wrong on the card (the JAX package's round-4 finding, which
its own ``tools/hw_oracle.py`` was written for).  Each case runs a kernel's
wrapper on bf16 inputs on the card and holds its outputs to the plain version
in fp32 on the same values (TF32 off), with the limits stated per output:

    python -m distillclip_tpu_torch.tools.hw_oracle                  # every case
    python -m distillclip_tpu_torch.tools.hw_oracle --only layer_norm_rows

``--only`` keeps the cases whose kernel name holds the word (a kernel or a
family: ``transform``, ``plain_attention``, ``dense``).  It prints one
``oracle`` line per case and exits 1 when any case disagrees.  ``--device
cpu`` runs the wrappers' plain versions (no card needed; a check of the
cases themselves, not of a kernel).  Run it after touching any kernel source.

``chip_smoke.py`` takes its oracle table from here (:func:`oracle_cases`,
:func:`check_case`, :func:`kernel_oracles`), and its timing helpers: the two
never disagree.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
PAIRS = 256     # samples at the serving and train shapes
DEVICE = "cuda"

# The card's published peaks (H100 SXM): device memory rate, dense bf16/fp16
# tensor-core rate, fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12


class Disagreement(AssertionError):
    """A kernel's output missed its limit against the plain version."""


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> Optional[float]:
    """Mean device time of fn() over ``iters`` calls captured in one CUDA
    graph and replayed, by CUDA events: the host's cost of a call (Python,
    argument checks, the launch itself) does not enter it, where a kernel
    shorter than its wrapper would otherwise time the host.  None where the
    calls cannot be captured."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
    except RuntimeError as err:
        torch.cuda.synchronize()
        print(f"graph capture failed ({str(err).splitlines()[0][:120]}); eager timing", flush=True)
        return None
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """(name, µs) of every kernel, copy and memset a profile recorded on the
    device."""
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and not str(getattr(ev, "device_type", "")).endswith("CPU"):
            yield ev.key, dev_us


def profiled_ms(fn, iters: int = 100) -> Optional[float]:
    """Mean device time of fn() over ``iters`` eager calls: the sum of the
    device times of the kernels they launch, read from torch.profiler, for a
    call that a graph cannot capture (an autograd backward, whose ops run on
    the forward's stream).  The host's cost between the kernels does not enter
    it.  None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(us for _, us in device_events(prof))
    return total / 1e3 / iters if total > 0 else None


def bf16(rng: np.random.Generator, shape, std: float = 1.0, mean: float = 0.0,
         device=DEVICE):
    a = rng.standard_normal(shape, dtype=np.float32) * np.float32(std) + np.float32(mean)
    return torch.from_numpy(a).to(device).to(torch.bfloat16)


# -- the cases ---------------------------------------------------------------

@dataclasses.dataclass
class Case:
    """One kernel at one shape.  ``run`` and ``ref`` return tuples of tensors,
    output by output; ``limits`` holds, per output, ("abs", max[, mean]) for an
    absolute limit on the error (and on its mean) or ("rel", x) for a limit on
    the largest error over the largest reference entry.  ``same`` returns the
    lean mode's output, which ``run()[0]`` must equal bit for bit; ``also``
    takes the outputs and returns a complaint or None.  ``plain`` is the plain
    version on the kernel's own bf16 inputs (timed, not compared); ``library``
    one PyTorch call that computes the same function, if any;
    ``library_eager`` says it runs through autograd, whose backward ops run
    on the streams of the forward and so stay out of a graph captured on
    another stream: its device time is read from the profiler.
    ``composition`` is a few PyTorch calls that do the same work where no
    one call does (timed beside the kernel, not in the JSON line's
    ``library_ms``).  ``times_of`` names, as (kernel, label), an earlier case
    at the same shape whose plain and composition times this case's line
    shows instead of timing its own."""

    kernel: str
    label: str
    run: Callable[[], tuple]
    ref: Callable[[], tuple]
    limits: tuple
    plain: Callable[[], object]
    flops: float
    nbytes: float
    peak: float = TENSOR_FLOPS
    same: Optional[Callable[[], torch.Tensor]] = None
    library: Optional[Callable[[], object]] = None
    also: Optional[Callable[[tuple], Optional[str]]] = None
    library_eager: bool = False
    composition: Optional[Callable[[], object]] = None
    times_of: Optional[tuple] = None

    def bound(self):
        by_bytes, by_ops = self.nbytes / HBM_BYTES_PER_S, self.flops / self.peak
        return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def _f32(ts):
    return [None if t is None else t.float() for t in ts]


def ln_gemm_act(x, g, b, w, bias, act, res=False):
    """K2's work in PyTorch's own kernels on bf16: native_layer_norm (with
    the rows' mean and rstd), the product with the bias, the activation;
    with ``res`` #8's, whose e is also returned: (h, u, e, mean, rstd)."""
    y, mean, rstd = torch.native_layer_norm(x, (x.shape[1],), g, b, 1e-5)
    u = torch.addmm(bias, y, w)
    if act == "gelu_exact":
        h = F.gelu(u)
        e = torch.erf(u * 0.7071067811865476) if res else None
    else:
        e = torch.sigmoid(1.702 * u)
        h = u * e
    return (h, u, e, mean, rstd) if res else h


def tf_composition(qkv, wl, ww, heads, seq, scale):
    """K3's work in PyTorch's own kernels on bf16: q·kᵀ by matmul, the two
    head mixes by einsum, the softmax, P'·v by matmul; (O [B·N, H·d], P).
    No one call computes the function (SDPA has no head mixes)."""
    rows = qkv.shape[0]
    q, k, v = qkv.view(rows // seq, seq, 3, heads, -1).permute(2, 0, 3, 1, 4)
    p = torch.softmax(torch.einsum("hg,bgnm->bhnm", wl, q @ k.transpose(-1, -2)) * scale,
                      dim=-1)
    o = torch.einsum("hg,bgnm->bhnm", ww, p) @ v
    return o.permute(0, 2, 1, 3).reshape(rows, -1), p


def tf_bwd_composition(qkv, wl, ww, do, p, heads, seq, scale):
    """#6's work in PyTorch's own kernels on bf16, from the saved P: the
    products by matmul, the head mixes and head-pair sums by einsum, the
    softmax's backward elementwise; (dqkv [B·N, 3·H·d], dwl, dww).  No one
    call computes the function."""
    rows = qkv.shape[0]
    q, k, v = qkv.view(rows // seq, seq, 3, heads, -1).permute(2, 0, 3, 1, 4)
    do4 = do.view(rows // seq, seq, heads, -1).permute(0, 2, 1, 3)
    g = do4 @ v.transpose(-1, -2)
    dv = torch.einsum("hg,bgnm->bhnm", ww, p).transpose(-1, -2) @ do4
    dww = torch.einsum("bhnm,bgnm->hg", g, p)
    dp = torch.einsum("hg,bhnm->bgnm", ww, g)
    ds2 = p * (dp - (p * dp).sum(-1, keepdim=True))
    dwl = scale * torch.einsum("bhnm,bgnm->hg", ds2, q @ k.transpose(-1, -2))
    ds = scale * torch.einsum("hg,bhnm->bgnm", wl, ds2)
    dqkv = torch.stack([ds @ k, ds.transpose(-1, -2) @ q, dv])
    return dqkv.permute(1, 3, 0, 2, 4).reshape(rows, -1), dwl, dww


def materialised_attention(qkv, heads, seq):
    """Attention of the fused rows materialised in the rows' dtype, as the
    EVA-02 tower ran it past 256 tokens before #13L: q·kᵀ on strided views,
    the scale, the softmax, P·v, the heads merged; [B·N, H·d]."""
    rows = qkv.shape[0]
    q, k, v = qkv.view(rows // seq, seq, 3, heads, -1).permute(2, 0, 3, 1, 4)
    s = (q @ k.transpose(-1, -2)) * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    return (torch.softmax(s, dim=-1) @ v).permute(0, 2, 1, 3).reshape(rows, -1)


def flash_tf_composition(q, k, v, wl, ww, scale, causal=False, kv_len=None):
    """#17's work in PyTorch's own kernels on bf16 [B, H, N, d] views: q·kᵀ by
    matmul, the wl mix by einsum, the mask, the softmax, the ww mix, P'·v by
    matmul.  No one call computes the function (SDPA has no head mixes)."""
    from distillclip_tpu_torch.ops.plain_attention import attention_mask

    s = torch.einsum("hg,bgnm->bhnm", wl, q @ k.transpose(-1, -2)) * scale
    N = q.shape[2]
    if causal or (kv_len is not None and kv_len < N):
        s = s.masked_fill(~attention_mask(N, causal, kv_len, q.device), -float("inf"))
    return torch.einsum("hg,bgnm->bhnm", ww, torch.softmax(s, dim=-1)) @ v


def oracle_cases(rng, samples: int = PAIRS, device=DEVICE, only: Optional[str] = None):
    """The cases, main-path shapes first for each kernel (the first case of a
    kernel gives its times in ``chip_smoke.py``'s JSON line), ``samples``
    at the serving and train shapes, on ``device``.  With ``only``, the
    families none of whose kernel names hold it are not built (their random
    inputs are not drawn, so the rest draw others).

    Every bf16 output rounds |y| in [2, 4) by up to 0.0078 and |y| in [4, 8)
    by up to 0.0156, so an absolute limit of 1e-2 or 8e-3 only holds while the
    outputs stay under 4, and 3e-2 while they stay under 8; the inputs below
    keep them there."""
    import importlib

    from distillclip_tpu_torch.ops import fc1_act, layer_norm, plain_attention as pa
    from distillclip_tpu_torch.ops import transform_attention as ta
    # ops.flash_attention is the public function; this is its module
    fa = importlib.import_module("distillclip_tpu_torch.ops.flash_attention")

    t = lambda shape, std=1.0, mean=0.0: bf16(rng, shape, std, mean, device)
    wants = lambda *kernels: only is None or any(only in k for k in kernels)
    cases = []
    C = 768
    img, txt = samples * 50, samples * 77

    # K1 / K2 / K2-residual / backward GEMM: LN output of std ~1 times W of
    # std 0.02 over C = 768 gives outputs of std ~0.55 (largest ~3.2 over 30M
    # values); du is unit-scale, so dxn = du·Wᵀ has std ~1 and dx stays under 8.
    def gemm_bytes(rows, c, n, outs):
        return 2 * (rows * c + c * n + 2 * c + n + outs * rows * n)

    def dense_cases(label, rows, c, n, bias, k1=True, k2=True, w_std=0.02,
                    act="gelu_exact", bwd=True):
        """K1 (with its statistics) and/or K2 (lean and residual mode, under
        ``act``) at one shape, and the backward GEMM of either unless the
        shape only runs without a gradient."""
        args = [t((rows, c)), t((c,), 0.1, 1.0), t((c,), 0.1), t((c, n), w_std),
                t((n,), 0.02) if bias else None]
        du = t((rows, n))
        flops = 2.0 * rows * c * n
        stat = ("rel", 1e-5)
        stats = fc1_act.dense_ln_stats_plain(*args)[1:]
        if bwd:
            cases.append(Case(
                "dense_ln_bwd", f"{label} [{rows},{n}]->{c}",
                lambda: fc1_act.dense_ln_bwd(*args[:4], du, *stats),
                lambda: fc1_act.dense_ln_bwd_plain(*_f32(args[:4]), du.float(), *stats),
                (("abs", 3e-2), ("abs", 3e-2), ("rel", 6e-3), ("rel", 6e-3)),
                lambda: fc1_act.dense_ln_bwd_plain(*args[:4], du, *stats), flops,
                2 * (3 * rows * c + rows * n + c * n + 2 * c) + 8 * rows + 8 * c))
        if bwd and k2:
            # K2's backward: #9 forms du = dh·act'(u) from dh, u and e itself
            _, u, e = fc1_act.dense_act_ln_res(*args, act)[:3]
            cases.append(Case(
                "dense_ln_bwd", f"{label} [{rows},{n}]->{c} from dh, u, e ({act})",
                lambda: fc1_act.dense_ln_bwd(*args[:4], du, *stats, act, u, e),
                lambda: fc1_act.dense_ln_bwd_plain(*_f32(args[:4]), du, *stats, act, u, e),
                (("abs", 3e-2), ("abs", 3e-2), ("rel", 6e-3), ("rel", 6e-3), ("abs", 3e-2)),
                lambda: fc1_act.dense_ln_bwd_plain(*args[:4], du, *stats, act, u, e), flops,
                2 * (3 * rows * c + 4 * rows * n + c * n + 2 * c) + 8 * rows + 8 * c,
                composition=lambda: fc1_act.dense_ln_bwd(
                    *args[:4], fc1_act._act_du(du, u, e, act), *stats)))
        if k1:
            cases.append(Case(
                "dense_ln", f"{label} [{rows},{c}]->{n}, with mean/rstd",
                lambda: fc1_act.dense_ln_fwd(*args, stats=True),
                lambda: fc1_act.dense_ln_stats_plain(*_f32(args)),
                (("abs", 1e-2, 1e-3), stat, stat),
                lambda: fc1_act.dense_ln_plain(*args), flops,
                gemm_bytes(rows, c, n, 1) + 8 * rows,
                same=lambda: fc1_act.dense_ln_fwd(*args)[0]))
        if not k2:
            return
        cases.append(Case(
            "dense_act_ln", f"{label} [{rows},{c}]->{n} {act}",
            lambda: (fc1_act.dense_act_ln(*args, act),),
            lambda: (fc1_act.dense_ln_plain(*_f32(args), act=act),),
            (("abs", 1e-2, 1e-3),),
            lambda: fc1_act.dense_ln_plain(*args, act=act), flops,
            gemm_bytes(rows, c, n, 1), composition=lambda: ln_gemm_act(*args, act)))
        cases.append(Case(
            "dense_act_ln_res", f"{label} [{rows},{c}]->{n} {act}",
            lambda: fc1_act.dense_act_ln_res(*args, act),
            lambda: fc1_act.dense_act_ln_res_plain(*_f32(args), act),
            (("abs", 1e-2, 1e-3), ("abs", 1e-2, 1e-3), ("abs", 1e-2, 1e-3), stat, stat),
            lambda: fc1_act.dense_act_ln_res_plain(*args, act), flops,
            gemm_bytes(rows, c, n, 3) + 8 * rows,
            same=lambda: fc1_act.dense_act_ln(*args, act),
            composition=lambda: ln_gemm_act(*args, act, res=True)))

    if wants("dense_ln", "dense_act_ln", "dense_act_ln_res", "dense_ln_bwd"):
        dense_cases("image qkv", img, C, 3 * C, True, k2=False)
        dense_cases("image fc1", img, C, 4 * C, True, k1=False)
        dense_cases("text qkv", txt, C, 3 * C, False, k2=False)
        dense_cases("text fc1", txt, C, 4 * C, True, k1=False)
        # the frozen teachers (ViT-B/32 architecture: image 768 wide, text 512
        # wide and causal at 77 tokens) run lean K1 and lean K2 under QuickGELU,
        # without a gradient; the residual mode under QuickGELU is the plain
        # CLIP-architecture students'
        dense_cases("image teacher fc1", img, C, 4 * C, True, k1=False, act="quick_gelu", bwd=False)
        dense_cases("text teacher qkv", txt, 512, 3 * 512, True, k2=False, bwd=False)
        dense_cases("text teacher fc1", txt, 512, 4 * 512, True, k1=False, act="quick_gelu",
                    bwd=False)
        dense_cases("ragged", 130, 256, 520, True, w_std=0.05)

    # The no-LN GEMM (#12 h only, #10 h/u/e, #11 u only): under fc1_ln "0"
    # fc1 takes norm2's output, unit-scale rows, so at W std 0.02 u has std
    # ~0.55 and stays under 4 over the 39M-60M values (the 8e-3 limit of
    # bf16 outputs); products of bf16 operands are exact, only the fp32 sum
    # and the store round.  #11's library call is F.linear; #10 and #12 have
    # none (F.linear + F.gelu is a scale line).
    def no_ln_cases(label, rows, c, n, act="gelu_exact", u_mode=True):
        x, w, b = t((rows, c)), t((c, n), 0.02), t((n,), 0.02)
        flops, lim = 2.0 * rows * c * n, ("abs", 8e-3, 1e-3)
        lean = lambda: fc1_act.dense_act(x, w, b, act)
        cases.append(Case(
            "dense_act", f"{label} [{rows},{c}]->{n} {act}", lambda: (lean(),),
            lambda: (fc1_act.dense_act_plain(x.float(), w.float(), b.float(), act),), (lim,),
            lambda: fc1_act.dense_act_plain(x, w, b, act), flops, gemm_bytes(rows, c, n, 1)))
        cases.append(Case(
            "dense_act_res", f"{label} [{rows},{c}]->{n} {act}",
            lambda: fc1_act.dense_act_res(x, w, b, act),
            lambda: fc1_act.dense_act_res_plain(x.float(), w.float(), b.float(), act),
            (lim, lim, lim), lambda: fc1_act.dense_act_res_plain(x, w, b, act), flops,
            gemm_bytes(rows, c, n, 3), same=lean))
        if u_mode:
            cases.append(Case(
                "dense_act_u", f"{label} [{rows},{c}]->{n}",
                lambda: (fc1_act.dense_act_u(x, w, b),),
                lambda: (fc1_act.dense_act_u_plain(x.float(), w.float(), b.float()),), (lim,),
                lambda: fc1_act.dense_act_u_plain(x, w, b), flops, gemm_bytes(rows, c, n, 1),
                same=lambda: fc1_act.dense_act_res(x, w, b, act)[1],
                library=lambda: F.linear(x, w.t(), b)))

    if wants("dense_act", "dense_act_res", "dense_act_u"):
        no_ln_cases("image fc1", img, C, 4 * C)
        no_ln_cases("text fc1", txt, C, 4 * C)
        no_ln_cases("image fc1", img, C, 4 * C, act="quick_gelu", u_mode=False)
        no_ln_cases("ragged", 130, 256, 520)

    if wants("transform_attention_rows_qkv", "transform_attention_save_p",
             "transform_attention_bwd", "transform_attention_rows_qkv_wide",
             "transform_attention_save_p_wide", "transform_attention_bwd_wide"):
        # K3 / save-P / backward: the head mixes are drawn at std H^-1/2, so the
        # mixed logits have std ~1 and the softmax is far from uniform; at the
        # towers' init std (0.02) it is nearly uniform and the check would be weak.
        # the students' shapes (first: their times stand in the JSON line), a
        # ragged one, and the widest heads the tensor-core pair takes: the
        # stage-1 ViT-L/14 student's (32 heads of 32 at 197 tokens, 1024 wide)
        # and 12 heads of 128 at 256 tokens
        for label, B, H, d, N in (("image", samples, 24, 32, 50), ("text", samples, 12, 64, 77),
                                  ("ragged", 64, 4, 16, 17),
                                  ("L/14 student", samples, 32, 32, 197),
                                  ("12 heads of 128", max(samples // 4, 1), 12, 128, 256)):
            qkv, do = t((B * N, 3 * H * d)), t((B * N, H * d))
            wl, ww = t((H, H), H ** -0.5), t((H, H), H ** -0.5)
            kw = dict(heads=H, seq=N, scale=d ** -0.5)
            shape = f"{label} B={B} H={H} d={d} N={N}"
            product, mix = 2.0 * B * H * N * N * d, 2.0 * B * H * H * N * N
            io = 2 * (B * N * 4 * H * d + 2 * H * H)
            pbytes = 2 * B * H * N * N
            lean = lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_rows_qkv(q, l, w, **k)
            comp = lambda q=qkv, l=wl, w=ww, k=kw: tf_composition(q, l, w, **k)
            cases.append(Case(
                "transform_attention_rows_qkv", shape,
                lambda f=lean: (f(),),
                lambda q=qkv, l=wl, w=ww, k=kw: (ta.transform_attention_rows_qkv_plain(
                    q.float(), l.float(), w.float(), **k),),
                (("abs", 8e-3),),
                lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_rows_qkv_plain(q, l, w, **k),
                2 * product + 2 * mix, io, composition=comp))
            cases.append(Case(
                "transform_attention_save_p", shape,
                lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_save_p(q, l, w, **k),
                lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_save_p_plain(
                    q.float(), l.float(), w.float(), **k),
                (("abs", 8e-3), ("abs", 4e-3)),
                lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_save_p_plain(q, l, w, **k),
                2 * product + 2 * mix, io + pbytes, same=lean, composition=comp))
            p = ta.transform_attention_save_p_plain(qkv, wl, ww, **kw)[1]
            bwd = lambda q=qkv, l=wl, w=ww, g=do, p=p, k=kw: ta.transform_attention_bwd(
                q, l, w, g, p, **k)
            cases.append(Case(
                "transform_attention_bwd", shape, bwd,
                lambda q=qkv, l=wl, w=ww, g=do, p=p, k=kw: ta.transform_attention_bwd_plain(
                    q.float(), l.float(), w.float(), g.float(), p.float(), **k),
                (("abs", 3e-2), ("rel", 6e-3), ("rel", 6e-3)),
                lambda q=qkv, l=wl, w=ww, g=do, p=p, k=kw: ta.transform_attention_bwd_plain(
                    q, l, w, g, p, **k),
                5 * product + 5 * mix,
                2 * (B * N * 7 * H * d + 2 * H * H) + pbytes + 8 * H * H,
                # the partials are added in a fixed order: a second run, the same bits
                also=lambda outs, f=bwd: None if all(
                    torch.equal(a, b) for a, b in zip(outs, f())) else "two runs differ",
                composition=lambda q=qkv, l=wl, w=ww, g=do, p=p, k=kw: tf_bwd_composition(
                    q, l, w, g, p, **k)))
        # #5 and #6's second route, the CUDA-core training pair: first at a
        # head shape past the tensor-core pair's (32 heads of 64, 2048 wide, at
        # 197 tokens; its times stand in the JSON line), then at the two widest
        # shapes the tensor-core pair takes, timed beside it (their plain and
        # composition times are the tensor-core cases'); limits as for #5 and #6
        for label, B, H, d, N in (("32 heads of 64", max(samples // 8, 1), 32, 64, 197),
                                  ("L/14 student", samples, 32, 32, 197),
                                  ("12 heads of 128", max(samples // 4, 1), 12, 128, 256)):
            qkv, do = t((B * N, 3 * H * d)), t((B * N, H * d))
            wl, ww = t((H, H), H ** -0.5), t((H, H), H ** -0.5)
            kw = dict(heads=H, seq=N, scale=d ** -0.5)
            shape = f"{label} B={B} H={H} d={d} N={N}"
            beside = label != "32 heads of 64"
            product, mix = 2.0 * B * H * N * N * d, 2.0 * B * H * H * N * N
            io, pbytes = 2 * (B * N * 4 * H * d + 2 * H * H), 2 * B * H * N * N
            cases.append(Case(
                "transform_attention_save_p_wide", shape,
                lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_save_p_wide(q, l, w, **k),
                lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_save_p_plain(
                    q.float(), l.float(), w.float(), **k),
                (("abs", 8e-3), ("abs", 4e-3)),
                lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_save_p_plain(q, l, w, **k),
                2 * product + 2 * mix, io + pbytes,
                same=lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_rows_qkv_wide(
                    q, l, w, **k),
                composition=lambda q=qkv, l=wl, w=ww, k=kw: tf_composition(q, l, w, **k),
                times_of=("transform_attention_save_p", shape) if beside else None))
            p = ta.transform_attention_save_p_plain(qkv, wl, ww, **kw)[1]
            cases.append(Case(
                "transform_attention_bwd_wide", shape,
                lambda q=qkv, l=wl, w=ww, g=do, p=p, k=kw: ta.transform_attention_bwd_wide(
                    q, l, w, g, p, **k),
                lambda q=qkv, l=wl, w=ww, g=do, p=p, k=kw: ta.transform_attention_bwd_plain(
                    q.float(), l.float(), w.float(), g.float(), p.float(), **k),
                (("abs", 3e-2), ("rel", 6e-3), ("rel", 6e-3)),
                lambda q=qkv, l=wl, w=ww, g=do, p=p, k=kw: ta.transform_attention_bwd_plain(
                    q, l, w, g, p, **k),
                5 * product + 5 * mix,
                2 * (B * N * 7 * H * d + 2 * H * H) + pbytes + 8 * H * H,
                composition=lambda q=qkv, l=wl, w=ww, g=do, p=p, k=kw: tf_bwd_composition(
                    q, l, w, g, p, **k),
                times_of=("transform_attention_bwd", shape) if beside else None))
        # K3's second route, the CUDA-core kernel, at a head shape past the
        # tensor-core kernel's (H > 16 at d > 32), the students' N
        B, H, d, N = samples, 32, 64, 50
        qkv, wl, ww = t((B * N, 3 * H * d)), t((H, H), H ** -0.5), t((H, H), H ** -0.5)
        kw = dict(heads=H, seq=N, scale=d ** -0.5)
        cases.append(Case(
            "transform_attention_rows_qkv_wide", f"B={B} H={H} d={d} N={N}",
            lambda q=qkv, l=wl, w=ww, k=kw: (ta.transform_attention_rows_qkv_wide(q, l, w, **k),),
            lambda q=qkv, l=wl, w=ww, k=kw: (ta.transform_attention_rows_qkv_plain(
                q.float(), l.float(), w.float(), **k),),
            (("abs", 8e-3),),
            lambda q=qkv, l=wl, w=ww, k=kw: ta.transform_attention_rows_qkv_plain(q, l, w, **k),
            4.0 * B * H * N * N * (d + H), 2 * (B * N * 4 * H * d + 2 * H * H),
            composition=lambda q=qkv, l=wl, w=ww, k=kw: tf_composition(q, l, w, **k)))

    if wants("plain_attention_rows_qkv", "plain_attention_save_p", "plain_attention_bwd"):
        # Plain attention, its save-P mode and its backward: the teachers' shapes,
        # the students' without head mixes, head shapes the TPU's block-diagonal
        # kernel rejects (5 heads; d = 48), and a ragged one with a short kv_len.
        # The library call is F.scaled_dot_product_attention on the same values as
        # [B, H, N, d] tensors, forward and backward (kv_len has no counterpart
        # there, so the ragged case has none).
        for label, B, H, d, N, causal, kv in (
                ("image teacher", samples, 12, 64, 50, False, None),
                ("text teacher", samples, 8, 64, 77, True, None),
                ("image student", samples, 24, 32, 50, False, None),
                ("text student", samples, 12, 64, 77, False, None),
                ("5 heads", 64, 5, 64, 33, False, None), ("5 heads", 64, 5, 64, 33, True, None),
                ("d=48", 64, 4, 48, 33, False, None), ("d=48", 64, 4, 48, 33, True, None),
                ("ragged", 64, 3, 16, 17, True, 13)):
            # q and k at unit scale (logits of std ~1); v at 0.7, so that the first
            # causal rows, which mix only two or three values, stay under 4 (the
            # 8e-3 limit; the row that sees one key returns v itself, exactly)
            qkv = torch.cat([t((B * N, 2 * H * d)), t((B * N, H * d), 0.7)], dim=1)
            do = t((B * N, H * d))
            kw = dict(heads=H, seq=N, scale=d ** -0.5)
            mask = dict(causal=causal, kv_len=kv)
            shape = (f"{label} B={B} H={H} d={d} N={N}" + (" causal" if causal else "")
                     + (f" kv_len={kv}" if kv else ""))
            # the (query, key) pairs this mask leaves: what the run's data needs
            pairs = float(pa.attention_mask(N, causal, kv, "cpu").sum())
            product = 2.0 * B * H * pairs * d
            io, pbytes = 2 * B * N * 4 * H * d, 2 * B * H * N * N
            q4, k4, v4 = (x.contiguous().requires_grad_()
                          for x in qkv.view(B, N, 3, H, d).permute(2, 0, 3, 1, 4))
            sdpa = None
            if kv is None:      # SDPA has no key limit; is_causal is the same mask
                sdpa = lambda q=q4, k=k4, v=v4, c=causal: F.scaled_dot_product_attention(
                    q, k, v, is_causal=c)
            lean = lambda q=qkv, k=kw, m=mask: pa.plain_attention_rows_qkv(q, **k, **m)
            cases.append(Case(
                "plain_attention_rows_qkv", shape, lambda f=lean: (f(),),
                lambda q=qkv, k=kw, m=mask: (
                    pa.plain_attention_rows_qkv_plain(q.float(), **k, **m),),
                (("abs", 8e-3),),
                lambda q=qkv, k=kw, m=mask: pa.plain_attention_rows_qkv_plain(q, **k, **m),
                2 * product, io, library=sdpa))
            hidden = ~pa.attention_mask(N, causal, kv, device)
            cases.append(Case(
                "plain_attention_save_p", shape,
                lambda q=qkv, k=kw, m=mask: pa.plain_attention_save_p(q, **k, **m),
                lambda q=qkv, k=kw, m=mask: pa.plain_attention_save_p_plain(q.float(), **k, **m),
                (("abs", 8e-3), ("abs", 4e-3)),
                lambda q=qkv, k=kw, m=mask: pa.plain_attention_save_p_plain(q, **k, **m),
                2 * product, io + pbytes, same=lean, library=sdpa,
                also=lambda outs, h=hidden: "a masked probability is not 0"
                if bool(outs[1][:, :, h].any()) else None))
            p = pa.plain_attention_save_p_plain(qkv, **kw, **mask)[1]
            sdpa_bwd = None
            if sdpa is not None:
                with torch.enable_grad():
                    o4 = sdpa()
                do4 = do.view(B, N, H, d).permute(0, 2, 1, 3).contiguous()
                sdpa_bwd = lambda o=o4, q=q4, k=k4, v=v4, g=do4: torch.autograd.grad(
                    o, (q, k, v), g, retain_graph=True)
            cases.append(Case(
                "plain_attention_bwd", shape,
                lambda q=qkv, g=do, p=p, k=kw: (pa.plain_attention_bwd(q, g, p, **k),),
                lambda q=qkv, g=do, p=p, k=kw: (pa.plain_attention_bwd_plain(
                    q.float(), g.float(), p.float(), **k),),
                (("abs", 3e-2),),
                lambda q=qkv, g=do, p=p, k=kw: pa.plain_attention_bwd_plain(q, g, p, **k),
                4 * product, 2 * B * N * 7 * H * d + pbytes, library=sdpa_bwd, library_eager=True))

    if wants("flash_attention_fwd", "flash_attention_bwd", "flash_transform_attention_fwd",
             "flash_transform_attention_fwd_wide"):
        # Attention on [B, H, N, d] views with the logsumexp residual (the towers
        # when they collect hidden states): forward, backward and the
        # head-transform forward, at the teachers' and the students' shapes.  The
        # main path hands the kernels strided views of the fused qkv (first, so
        # their times stand in the JSON line); a contiguous case, a causal one and
        # a ragged one with a short kv_len follow.  Limits as for the fused-qkv
        # kernels: forward 8e-3 (outputs under 4), dq/dk/dv 3e-2 (under 8), the
        # fp32 logsumexp 1e-3.  The library call is SDPA on contiguous copies.
        for label, B, H, d, N, causal, kv, strided in (
                ("image teacher", samples, 12, 64, 50, False, None, True),
                ("text teacher", samples, 8, 64, 77, True, None, True),
                ("image student", samples, 24, 32, 50, False, None, True),
                ("text student", samples, 12, 64, 77, False, None, True),
                ("image teacher, contiguous", samples, 12, 64, 50, False, None, False),
                ("ragged", 64, 3, 16, 17, True, 13, True),
                ("ragged, contiguous", 64, 5, 48, 33, False, 29, False)):
            qkv = torch.cat([t((B, N, 2, H, d)), t((B, N, 1, H, d), 0.7)], dim=2)
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
            do = t((B, N, H, d)).permute(0, 2, 1, 3)       # as an output projection's gradient
            if not strided:
                q, k, v, do = (x.contiguous() for x in (q, k, v, do))
            kw = dict(scale=d ** -0.5, causal=causal, kv_len=kv)
            shape = (f"{label} B={B} H={H} d={d} N={N}" + (" causal" if causal else "")
                     + (f" kv_len={kv}" if kv else "")
                     + (", views of a fused qkv" if strided else ""))
            pairs = float(pa.attention_mask(N, causal, kv, "cpu").sum())
            product = 2.0 * B * H * pairs * d
            tensor, lse_bytes = 2 * B * N * H * d, 4 * B * H * N
            sdpa = sdpa_bwd = None
            if kv is None:
                q4, k4, v4 = (x.contiguous().requires_grad_() for x in (q, k, v))
                sdpa = lambda q=q4, k=k4, v=v4, c=causal: F.scaled_dot_product_attention(
                    q, k, v, is_causal=c)
                with torch.enable_grad():
                    o4 = sdpa()
                sdpa_bwd = lambda o=o4, q=q4, k=k4, v=v4, g=do.contiguous(): torch.autograd.grad(
                    o, (q, k, v), g, retain_graph=True)
            f32 = lambda *xs: [x.float() for x in xs]
            cases.append(Case(
                "flash_attention_fwd", shape,
                lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_fwd(q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_fwd_plain(*f32(q, k, v), **kw),
                (("abs", 8e-3), ("abs", 1e-3)),
                lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_fwd_plain(q, k, v, **kw),
                2 * product, 4 * tensor + lse_bytes, library=sdpa))
            with torch.no_grad():
                o, lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
                o = o.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3) if strided else o
            cases.append(Case(
                "flash_attention_bwd", shape,
                lambda q=q, k=k, v=v, o=o, l=lse, g=do, kw=kw: fa.flash_attention_bwd(
                    q, k, v, o, l, g, **kw),
                lambda q=q, k=k, v=v, o=o, l=lse, g=do, kw=kw: fa.flash_attention_bwd_plain(
                    *f32(q, k, v, o), l, g.float(), **kw),
                (("abs", 3e-2), ("abs", 3e-2), ("abs", 3e-2)),
                lambda q=q, k=k, v=v, o=o, l=lse, g=do, kw=kw: fa.flash_attention_bwd_plain(
                    q, k, v, o, l, g, **kw),
                5 * product, 8 * tensor + lse_bytes, library=sdpa_bwd, library_eager=True))
            if "teacher" in label:
                continue        # the teachers have no head mixes
            # under the causal mask the first rows see one or two keys, so their
            # output is Σ_g Ww[h, g] times v itself: Ww at half the scale keeps it under 4
            wl, ww = t((H, H), H ** -0.5), t((H, H), H ** -0.5 * (0.5 if causal else 1.0))
            mix = 2.0 * B * H * H * pairs
            cases.append(Case(
                "flash_transform_attention_fwd", shape,
                lambda q=q, k=k, v=v, l=wl, w=ww, kw=kw: (fa.flash_transform_attention_fwd(
                    q, k, v, l, w, **kw),),
                lambda q=q, k=k, v=v, l=wl, w=ww, kw=kw: (fa.flash_transform_attention_fwd_plain(
                    *f32(q, k, v, l, w), **kw),),
                (("abs", 8e-3),),
                lambda q=q, k=k, v=v, l=wl, w=ww, kw=kw: fa.flash_transform_attention_fwd_plain(
                    q, k, v, l, w, **kw),
                2 * product + 2 * mix, 4 * tensor + 4 * H * H,
                composition=lambda q=q, k=k, v=v, l=wl, w=ww, kw=kw: flash_tf_composition(
                    q, k, v, l, w, **kw)))
        # #17 at the widest head shapes it takes, on views of a fused qkv: 32
        # heads of 32 at the students' N and at 197 tokens (a 32-head student
        # against ViT-B/16), 12 heads of 128 at 256; then its second route, the
        # CUDA-core kernel, first at a head shape past the tensor-core kernel's
        # (32 heads of 64, 2048 wide, at 197 tokens; its times stand in the JSON
        # line), then beside #17 at the two widest of those shapes (their plain
        # and composition times are #17's).  Limits as above.
        wide = (("32 heads", samples, 32, 32, 50), ("L/14 student", samples, 32, 32, 197),
                ("12 heads of 128", max(samples // 4, 1), 12, 128, 256))
        for kernel, cases_at in (
                ("flash_transform_attention_fwd", wide),
                ("flash_transform_attention_fwd_wide",
                 (("32 heads of 64", max(samples // 8, 1), 32, 64, 197),) + wide[1:])):
            for label, B, H, d, N in cases_at:
                qkv = torch.cat([t((B, N, 2, H, d)), t((B, N, 1, H, d), 0.7)], dim=2)
                q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
                wl, ww = t((H, H), H ** -0.5), t((H, H), H ** -0.5)
                kw = dict(scale=d ** -0.5)
                shape = f"{label} B={B} H={H} d={d} N={N}, views of a fused qkv"
                beside = kernel.endswith("_wide") and label != "32 heads of 64"
                fn = getattr(fa, kernel)
                cases.append(Case(
                    kernel, shape,
                    lambda q=q, k=k, v=v, l=wl, w=ww, kw=kw, f=fn: (f(q, k, v, l, w, **kw),),
                    lambda q=q, k=k, v=v, l=wl, w=ww, kw=kw: (
                        fa.flash_transform_attention_fwd_plain(
                            *[x.float() for x in (q, k, v, l, w)], **kw),),
                    (("abs", 8e-3),),
                    lambda q=q, k=k, v=v, l=wl, w=ww, kw=kw: fa.flash_transform_attention_fwd_plain(
                        q, k, v, l, w, **kw),
                    4.0 * B * H * N * N * (d + H), 2 * (4 * B * N * H * d + 2 * H * H),
                    composition=lambda q=q, k=k, v=v, l=wl, w=ww, kw=kw: flash_tf_composition(
                        q, k, v, l, w, **kw),
                    times_of=("flash_transform_attention_fwd", shape) if beside else None))

    if wants("layer_norm_rows", "layer_norm_rows_bwd"):
        # K4 and its backward: rows uniform on [-sqrt(3), sqrt(3)] (unit variance),
        # so the normalised values stay within sqrt(3) and |y| within ~2.2; unit
        # Gaussian rows put ~50 of the 786k outputs past 4.
        # [12800, 768] is also the image student's under need_last_layer (fine_grain),
        # and [19712, 768] the text student's: there the backward runs at those rows
        for rows, c in ((1024, C), (samples, C), (img, C), (txt, 512), (txt, C), (77, 40)):
            x = rng.uniform(-3 ** 0.5, 3 ** 0.5, size=(rows, c)).astype(np.float32)
            args = [torch.from_numpy(x).to(device).to(torch.bfloat16), t((c,), 0.1, 1.0),
                    t((c,), 0.1)]
            g = t((rows, c))
            stat = ("rel", 1e-5)
            cases.append(Case(
                "layer_norm_rows", f"[{rows},{c}], with mean/rstd",
                lambda a=args: layer_norm.layer_norm_rows_fwd(*a, stats=True),
                lambda a=args: layer_norm.layer_norm_rows_stats_plain(*_f32(a)),
                (("abs", 1e-2), stat, stat),
                lambda a=args: layer_norm.layer_norm_rows_plain(*a), 8.0 * rows * c,
                2 * (2 * rows * c + 2 * c) + 8 * rows, FP32_FLOPS,
                same=lambda a=args: layer_norm.layer_norm_rows_fwd(*a)[0],
                library=lambda a=args, c=c: F.layer_norm(a[0], (c,), a[1], a[2], 1e-5)))
            if (rows, c) not in ((samples, C), (img, C), (txt, C), (77, 40)):
                continue    # serving and teacher shapes; the backward runs at the train steps' rows
            _, mean, rstd = torch.native_layer_norm(args[0], (c,), args[1], args[2], 1e-5)
            stats = layer_norm.layer_norm_rows_stats_plain(*args)[1:]
            cases.append(Case(
                "layer_norm_rows_bwd", f"[{rows},{c}]",
                lambda a=args, g=g, s=stats: layer_norm.layer_norm_rows_bwd(a[0], a[1], g, *s),
                lambda a=args, g=g, s=stats: layer_norm.layer_norm_rows_bwd_plain(
                    a[0].float(), a[1].float(), g.float(), *s),
                (("abs", 3e-2), ("rel", 6e-3), ("rel", 6e-3)),
                lambda a=args, g=g, s=stats: layer_norm.layer_norm_rows_bwd_plain(
                    a[0], a[1], g, *s),
                14.0 * rows * c, 2 * (3 * rows * c + c) + 8 * rows + 8 * c, FP32_FLOPS,
                library=lambda a=args, g=g, c=c, m=mean, r=rstd:
                    torch.ops.aten.native_layer_norm_backward(
                        g, a[0], [c], m, r, a[1], a[2], [True, True, True])))
    # EVA-02's forward modes of the LN GEMM (the frozen EVA-02-CLIP teacher),
    # last, so that the other cases draw the inputs they drew before them,
    # at the EVA cell's shapes, 4·samples pictures of 257 tokens (263,168 rows
    # at 256): K1r (1024 -> 3072, q and k turned), K2g (1024 -> 2 x 2752
    # interleaved, 2752 out) and K1w (2752 wide, zero past 2730, -> 1024).
    # W's std keeps u's std near 0.5 (largest ~3 over 0.3-0.8G values);
    # SwiGLU's h stays under 1.  K1w also holds its moments to the true width:
    # over the padded row, rows of mean 0.5 and std 0.3 would lose 0.8% of
    # their mean in the centring (a shift of 1.3% of a std) and rstd 0.4%, under
    # the bf16 store's rounding element by element but not on the mean.
    def eva_cases():
        from distillclip_tpu_torch.models.eva_vit import rope_table

        seq, E, hd, width = 257, 1024, 64, 2730
        hp, rows = -(-width // 32) * 32, 4 * samples * seq
        x, g, lb = t((rows, E)), t((E,), 0.1, 1.0), t((E,), 0.1)
        ln = lambda a, gg, bb, c=E: F.layer_norm(a, (c,), gg, bb, 1e-6)
        cs = rope_table(16, hd).to(device)
        w, b = t((E, 3 * E), 0.015), t((3 * E,), 0.02)
        args = (x, g, lb, w, b, cs, seq, hd, 2 * E, 1e-6)
        cases.append(Case(
            "dense_ln_rope", f"EVA qkv [{rows},{E}]->{3 * E}, rotary on q and k",
            lambda: (fc1_act.dense_ln_rope(*args),),
            lambda: (fc1_act.dense_ln_rope_plain(*_f32(args[:6]), *args[6:]),),
            (("abs", 1e-2, 1e-3),), lambda: fc1_act.dense_ln_rope_plain(*args),
            2.0 * rows * E * 3 * E, gemm_bytes(rows, E, 3 * E, 1) + 4 * cs.numel(),
            composition=lambda: fc1_act.rotate_pairs(torch.addmm(b, ln(x, g, lb), w), cs,
                                                     seq, hd, 2 * E)))
        w12, b12 = t((E, 2 * hp), 0.015), t((2 * hp,), 0.02)
        cases.append(Case(
            "dense_swiglu_ln", f"EVA SwiGLU [{rows},{E}]->2x{hp}, {hp} out",
            lambda: (fc1_act.dense_swiglu_ln(x, g, lb, w12, b12, 1e-6),),
            lambda: (fc1_act.dense_swiglu_ln_plain(*_f32((x, g, lb, w12, b12)), 1e-6),),
            (("abs", 1e-2, 1e-3),), lambda: fc1_act.dense_swiglu_ln_plain(x, g, lb, w12, b12),
            2.0 * rows * E * 2 * width,
            2 * (rows * E + E * 2 * width + 2 * E + 2 * width + rows * width),
            composition=lambda: fc1_act.swiglu_pairs(torch.addmm(b12, ln(x, g, lb), w12))))
        h, gh, bh, w3, b3 = (t((rows, hp), 0.3, 0.5), t((hp,), 0.1, 1.0), t((hp,), 0.1),
                             t((hp, E), 0.01), t((E,), 0.02))
        for pad in (h[:, width:], gh[width:], bh[width:], w3[width:]):
            pad.zero_()
        wargs = (h, gh, bh, w3, b3)

        def true_moments(outs):
            """The kernel nearer the true width's moments than the padded row's."""
            true = fc1_act.dense_ln_width_plain(*_f32(wargs), width, 1e-6)
            padded = fc1_act.dense_ln_width_plain(*_f32(wargs), hp, 1e-6)
            near = (outs[0].float() - true).abs().mean().item()
            far = (outs[0].float() - padded).abs().mean().item()
            return None if near < 0.5 * far else (
                f"mean gap {near:.3e} to the true width's moments, {far:.3e} to the padded "
                f"row's (want under half)")

        cases.append(Case(
            "dense_ln_width", f"EVA w3 [{rows},{hp}] (moments over {width})->{E}",
            lambda: (fc1_act.dense_ln_width(*wargs, width, 1e-6),),
            lambda: (fc1_act.dense_ln_width_plain(*_f32(wargs), width, 1e-6),),
            (("abs", 1e-2, 1e-3),), lambda: fc1_act.dense_ln_width_plain(*wargs, width),
            2.0 * rows * width * E, gemm_bytes(rows, width, E, 1), also=true_moments,
            composition=lambda: torch.addmm(b3, ln(h[:, :width], gh[:width], bh[:width],
                                                   width), w3[:width])))

    if wants("dense_ln_rope", "dense_swiglu_ln", "dense_ln_width"):
        eva_cases()
    # #13L, plain attention past 256 tokens, last, so that every case above
    # draws the inputs it drew before: the EVA cell's 4·samples pictures of 257
    # tokens, 16 heads of 64, inputs drawn as #13's (q, k at unit scale, v at
    # 0.7), held to #13's limit.  The library time is the composition the
    # kernel replaced in the EVA tower, its attention materialised in bf16
    # (the port no longer calls it).
    if wants("plain_attention_long"):
        B, H, d, N = 4 * samples, 16, 64, 257
        qkv = torch.cat([t((B * N, 2 * H * d)), t((B * N, H * d), 0.7)], dim=1)
        kw = dict(heads=H, seq=N, scale=d ** -0.5)
        cases.append(Case(
            "plain_attention_long", f"EVA teacher B={B} H={H} d={d} N={N}",
            lambda: (pa.plain_attention_long(qkv, heads=H, seq=N),),
            lambda: (pa.plain_attention_rows_qkv_plain(qkv.float(), **kw),),
            (("abs", 8e-3),), lambda: pa.plain_attention_rows_qkv_plain(qkv, **kw),
            4.0 * B * H * N * N * d, 2 * B * N * 4 * H * d,
            library=lambda: materialised_attention(qkv, H, N)))
    return cases


def check_case(case: Case) -> float:
    """Hold one case's outputs to their limits and print its ``oracle`` line;
    returns the largest absolute error of its abs-limited outputs and raises
    :class:`Disagreement` where an output misses its limit."""
    outs = case.run()
    _synchronize()
    refs = case.ref()
    if case.same is not None and not torch.equal(outs[0], case.same()):
        raise Disagreement(f"{case.kernel} {case.label}: the first output differs from the "
                           f"lean mode's")
    if case.also is not None and (complaint := case.also(outs)):
        raise Disagreement(f"{case.kernel} {case.label}: {complaint}")
    worst, notes = 0.0, []
    for i, (out, ref, limit) in enumerate(zip(outs, refs, case.limits)):
        out, ref = out.float(), ref.float()
        if out.shape != ref.shape or not torch.isfinite(out).all() \
                or not torch.isfinite(ref).all():
            raise Disagreement(f"{case.kernel} {case.label}: output {i} has shape "
                               f"{tuple(out.shape)} (want {tuple(ref.shape)}) or is not "
                               f"finite")
        diff = (out - ref).abs()
        err = diff.max().item()
        if limit[0] == "rel":
            err /= max(ref.abs().max().item(), 1e-30)
            notes.append(f"out{i} rel {err:.3e} (limit {limit[1]:g})")
            bad = err > limit[1]
        else:
            worst = max(worst, err)
            mean = diff.mean().item()
            notes.append(f"out{i} max_abs {err:.3e} (limit {limit[1]:g}) mean_abs {mean:.3e}"
                         + (f" (limit {limit[2]:g})" if len(limit) > 2 else ""))
            bad = err > limit[1] or (len(limit) > 2 and mean > limit[2])
        if bad:
            print(f"oracle {case.kernel} {case.label}: " + "; ".join(notes), flush=True)
            raise Disagreement(f"{case.kernel} {case.label}: output {i} disagrees with its "
                               f"plain version")
    print(f"oracle {case.kernel} {case.label}: " + "; ".join(notes)
          + ("; out0 bit-identical to the lean mode" if case.same else ""), flush=True)
    return worst


def kernel_oracles(card: str):
    """Every case checked and timed on the card: per kernel, the worst error
    over its shapes and, at its first (main-path) shape, the kernel / plain /
    library times and the bound; beside them the kernel time of every case,
    by (kernel, label).  Raises :class:`Disagreement` at the first case that
    misses a limit."""
    results, case_ms, side_ms = {}, {}, {}
    for case in oracle_cases(np.random.default_rng(SEED)):
        with torch.no_grad():
            err = check_case(case)
            # the kernel and the library call replayed from a CUDA graph (their
            # device time), eager where a call cannot be captured; the plain
            # version, many small launches, eager; the library calls are short:
            # more calls for a steadier mean.  A library call through autograd
            # is timed at the end of the run (library_device_times).
            ms = graph_ms(case.run) or cuda_ms(case.run)
            of = side_ms.get(case.times_of)
            plain_ms = of[0] if of else cuda_ms(case.plain)
            lib_ms = None
            if case.library is not None and not case.library_eager:
                lib_ms = graph_ms(case.library, 100) or cuda_ms(case.library, 100, 10)
            comp, comp_ms = "", None
            if case.composition is not None:
                comp_ms = of[1] if of else graph_ms(case.composition) or cuda_ms(case.composition)
                comp = f", composition {comp_ms:.4f} ms (kernel / composition {ms / comp_ms:.2f})"
        case_ms[case.kernel, case.label] = ms
        side_ms[case.kernel, case.label] = plain_ms, comp_ms
        bound_ms, bound_by = case.bound()
        print(f"time {case.kernel} {case.label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({case.flops / 1e9:.3f} GFLOP, "
              f"{case.nbytes / 1e6:.3f} MB, {bound_ms / ms:.3f} of it), library "
              + ("at the end of the run" if case.library_eager
                 else "none" if lib_ms is None
                 else f"{lib_ms:.4f} ms (kernel / library {ms / lib_ms:.2f})") + comp
              + (f" (plain and composition: {case.times_of[0]}'s)" if of else "")
              + f" [{card}]", flush=True)
        r = results.setdefault(case.kernel, {
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms})
        r["max_abs_err"] = max(r["max_abs_err"], err)
    return results, case_ms


def library_device_times(results: dict, case_ms: dict, card: str) -> None:
    """The library calls that run through autograd (SDPA's backward): the
    device time of their kernels from torch.profiler, at the cases' shapes,
    the first into the kernel's ``library_ms``.  Measured after every step
    timing: eager steps that run after a profiler session are slower."""
    seen = set()
    for case in oracle_cases(np.random.default_rng(SEED)):
        if not case.library_eager or case.library is None:
            continue
        with torch.no_grad():
            lib_ms = profiled_ms(case.library) or cuda_ms(case.library, 100, 10)
        ms = case_ms[case.kernel, case.label]
        print(f"time {case.kernel} {case.label}: library {lib_ms:.4f} ms, device time of its "
              f"kernels (kernel / library {ms / lib_ms:.2f}) [{card}]", flush=True)
        if case.kernel not in seen:
            results[case.kernel]["library_ms"] = lib_ms
            seen.add(case.kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="keep the cases whose kernel name holds this word")
    ap.add_argument("--device", default=DEVICE, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("hw_oracle: no CUDA device (pass --device cpu to check the cases on the CPU)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [c for c in oracle_cases(np.random.default_rng(SEED), PAIRS, args.device, args.only)
             if args.only is None or args.only in c.kernel]
    if not cases:
        print(f"hw_oracle: no case of a kernel named like {args.only!r}", file=sys.stderr)
        return 2
    bad = []
    for case in cases:
        try:
            with torch.no_grad():
                check_case(case)
        except Disagreement as err:
            print(f"FAIL {err}", flush=True)
            bad.append(f"{case.kernel} {case.label}")
    print(f"hw_oracle: {len(cases) - len(bad)} of {len(cases)} cases agree on {args.device}"
          + (f"; disagree: {bad}" if bad else ""), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
