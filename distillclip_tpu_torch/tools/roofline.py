"""Component roofline of the port's train steps on the H100.

An analytic FLOP and device-memory byte count per op family of the final
configs' steps, against the card's peaks, so that each component's distance
from its own floor is visible beside a measured step:

    python -m distillclip_tpu_torch.tools.roofline --stage text --batch 256 \
        [--step-ms 23.5] [--json]

Port of ``distillclip_tpu/tools/roofline.py``, on the port's shapes: the
towers run at the true token count (no padding to 16), and the FLOPs issued
are what the port's kernels issue.  Head-transform attention forward with
saved P (#5) issues two products and two head mixes, its backward (#6) five
of each; the true count needs six mixes (the JAX package's TPU kernel issued
its column-concatenated products, H times the work).  Peaks: 989 TFLOP/s
dense bf16 on the tensor cores and 3.35 TB/s of device memory (H100 SXM, as
``chip_smoke.py``'s bounds use); the floor of a component is the larger of
its FLOPs over the first and its bytes over the second, in ms.

Stages: ``text`` (stage 2, cached teacher: the text student of
``configs/final/text.yaml``), ``image`` (stage 1's student alone) and
``joint`` (stage 3 with the text teacher cached: both students and the live
ViT-B/32 image teacher, forward only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

PEAK_BF16_TFLOPS = 989.0     # dense bf16 on the tensor cores, H100 SXM
PEAK_HBM_TBS = 3.35          # device memory, H100 SXM
GF, GB = 1e9, 1e9


@dataclasses.dataclass
class Component:
    name: str
    gflops: float                           # FLOPs the math needs, per step
    gbytes: float                           # device-memory traffic it cannot avoid, per step
    issued_gflops: Optional[float] = None   # FLOPs the port's kernels issue, where they differ

    @property
    def min_ms(self) -> float:
        """The floor at the card's peaks: max(compute, memory) in ms."""
        return max((self.issued_gflops or self.gflops) / PEAK_BF16_TFLOPS,
                   self.gbytes / PEAK_HBM_TBS)


def text_components(B: int, depth: int = 4, N: int = 77, h: int = 12, d: int = 64,
                    vocab: int = 49408, out_dim: int = 512) -> List[Component]:
    """The stage-2 text step with the teacher cached (configs/final/text.yaml
    shapes): ``depth`` logical layers (the weight-share blocks run
    ``depth / repeats`` parameter blocks ``repeats`` times each, so every
    logical layer is one application), each dense forward 2·rows·Cin·Cout
    FLOPs and its backward twice that (dX and dW)."""
    C, L, rows = h * d, depth, B * N

    def dense(cin, cout, name):
        flops = 2 * rows * cin * cout * L * 3                 # forward + dX + dW
        nbytes = rows * (cin + cout) * 2 * L * 2              # bf16 in and out, fwd and bwd
        return Component(name, flops / GF, nbytes / GB)

    comps = [dense(C, 3 * C, "qkv projection (K1 / #9)"), dense(C, C, "attn out proj"),
             dense(C, 4 * C, "mlp fc1 + gelu (#8 / #9)"), dense(4 * C, C, "mlp fc2")]
    product, mix = 2 * B * h * N * N * d, 2 * B * h * h * N * N
    true_attn = (2 + 5) * product + 6 * mix
    issued = (2 + 5) * product + (2 + 5) * mix               # #5 forward, #6 backward
    pbytes = 2 * B * h * N * N
    attn_bytes = (2 * rows * 4 * C + pbytes) + (2 * rows * 7 * C + pbytes)
    comps.append(Component("transform attention (#5 + #6)", true_attn * L / GF,
                           attn_bytes * L / GB, issued_gflops=issued * L / GF))
    ln_apps = 2 * L + 1       # the folded norms' statistics and the final norm
    comps.append(Component("layernorm (fwd+bwd)", 4 * rows * C * ln_apps / GF,
                           2 * (rows * C * 2 * 2) * ln_apps / GB))
    comps.append(Component("embed + eot head", 2 * B * C * out_dim * 3 / GF,
                           (rows * C * 2 * 2 + B * out_dim * 4) / GB))
    comps.append(Component("losses", 2 * B * out_dim * 10 / GF, B * out_dim * 4 * 6 / GB))
    # AdamW on fp32 masters (p, m, v read and written, g read) and the bf16 cast
    n_params = (C * 3 * C + C * C + C * 4 * C * 2) * depth + vocab * C + C * out_dim
    comps.append(Component("adamw + casts", 10 * n_params / GF, n_params * 4 * 6 / GB))
    return comps


def image_components(B: int, depth: int = 6, N: int = 50, h: int = 24,
                     d: int = 32) -> List[Component]:
    """The stage-1 / stage-3 image student (weight-share ViT, final configs)."""
    return text_components(B, depth=depth, N=N, h=h, d=d, vocab=0, out_dim=512)


def joint_components(B: int) -> List[Component]:
    """The stage-3 step of configs/final/l_clip.yaml with the text teacher
    cached: both students, and the live frozen ViT-B/32 image teacher forward
    only (12 plain layers, 12 heads of 64 at 50 tokens)."""
    comps = []
    for prefix, part in (("img-stu ", image_components(B)), ("txt-stu ", text_components(B))):
        for c in part:
            comps.append(dataclasses.replace(c, name=prefix + c.name))
    rows, C = B * 50, 768
    t_dense = 2 * rows * (C * 3 * C + C * C + 2 * C * 4 * C) * 12
    t_attn = 2 * B * 2 * 12 * 50 * 50 * 64 * 12
    comps.append(Component("img-teacher fwd (12L, no bwd)", (t_dense + t_attn) / GF,
                           rows * C * 2 * 4 * 12 / GB))
    comps.append(Component("patchify embeds", 2 * B * 49 * 3072 * C * 2 * 2 / GF,
                           B * 224 * 224 * 3 * 2 / GB))
    return comps


STAGES = {"text": text_components, "image": image_components, "joint": joint_components}


def roofline(stage: str, batch: int) -> dict:
    comps = STAGES[stage](batch)
    return {
        "stage": stage, "batch": batch,
        "peaks": {"bf16_tflops": PEAK_BF16_TFLOPS, "hbm_tbs": PEAK_HBM_TBS},
        "true_gflops": sum(c.gflops for c in comps),
        "issued_gflops": sum(c.issued_gflops or c.gflops for c in comps),
        "floor_ms": sum(c.min_ms for c in comps),
        "components": [{"name": c.name, "gflops": c.gflops,
                        "issued_gflops": c.issued_gflops or c.gflops, "gbytes": c.gbytes,
                        "min_ms": c.min_ms} for c in comps],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=sorted(STAGES), default="text")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--step-ms", type=float, default=None,
                    help="a measured step's ms, for its ratio to the floor")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    out = roofline(args.stage, args.batch)
    if args.step_ms:
        out["step_ms"] = args.step_ms
        out["step_over_floor"] = args.step_ms / out["floor_ms"]
    if args.json:
        print(json.dumps(out))
        return 0
    print(f"stage={args.stage} batch={args.batch}  (peaks: {PEAK_BF16_TFLOPS} TFLOP/s bf16, "
          f"{PEAK_HBM_TBS} TB/s)")
    hdr = f"{'component':44s} {'true GF':>9s} {'issued GF':>10s} {'GB':>7s} {'min ms':>8s}"
    print(hdr)
    print("-" * len(hdr))
    for c in out["components"]:
        print(f"{c['name']:44s} {c['gflops']:9.1f} {c['issued_gflops']:10.1f} "
              f"{c['gbytes']:7.3f} {c['min_ms']:8.4f}")
    print("-" * len(hdr))
    print(f"{'TOTAL (serial floor)':44s} {out['true_gflops']:9.1f} "
          f"{out['issued_gflops']:10.1f} {'':7s} {out['floor_ms']:8.4f}")
    if args.step_ms:
        print(f"measured step: {args.step_ms:.2f} ms -> {out['step_over_floor']:.2f}x the "
              f"component floor")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
