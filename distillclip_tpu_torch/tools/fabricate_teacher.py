"""Fabricate a CLIP-format checkpoint with random weights.

For offline development, smoke runs and tests where no OpenAI checkpoint is at
hand: a ``torch.save`` state dict with OpenAI CLIP's key names, which the
teacher loader reads.  The same seed gives the same tensors as the JAX
package's ``tools/fabricate_teacher.py``, so one saved file feeds both;
:func:`make_rn_state_dict` writes an RN-class (ModifiedResNet) checkpoint the
same way, and :func:`make_eva_state_dict` (``--eva``) an EVA-02-CLIP vision
tower in EVA-CLIP's layout, which the port alone reads.

    python -m distillclip_tpu_torch.tools.fabricate_teacher --out .cache/tiny_clip.pt \
        --vision-width 64 --vision-layers 3 --text-width 64 --text-layers 2
    python -m distillclip_tpu_torch.tools.fabricate_teacher --out vit_l14.pt --preset ViT-L/14
    python -m distillclip_tpu_torch.tools.fabricate_teacher --out eva.pt --eva --vision-width 64

``--preset`` takes a published geometry (:data:`PRESETS`: the ViT CLIP
models' widths, depths, patch sizes, resolutions and embedding widths) with
seeded weights; any geometry flag given beside it overrides that value (a
cut depth, say).  The loader infers the heads from the widths, 64 a head, as
OpenAI's ``build_model`` does.
"""

from __future__ import annotations

import argparse
import os

import torch


# Published CLIP ViT geometries: OpenAI CLIP's clip/model.py build_model (the
# checkpoints' tensor shapes) and the CLIP paper's model table (Radford et al.
# 2021, table 20).  Every one has a 77-token context and a 49408-word vocabulary.
PRESETS = {
    "ViT-B/32": dict(vision_width=768, vision_layers=12, patch_size=32, image_resolution=224,
                     text_width=512, text_layers=12, embed_dim=512),
    "ViT-B/16": dict(vision_width=768, vision_layers=12, patch_size=16, image_resolution=224,
                     text_width=512, text_layers=12, embed_dim=512),
    "ViT-L/14": dict(vision_width=1024, vision_layers=24, patch_size=14, image_resolution=224,
                     text_width=768, text_layers=12, embed_dim=768),
    "ViT-L/14@336px": dict(vision_width=1024, vision_layers=24, patch_size=14,
                           image_resolution=336, text_width=768, text_layers=12,
                           embed_dim=768),
}


def preset_state_dict(name: str, seed: int = 0, **overrides):
    """A seeded checkpoint of the published geometry ``name`` (a key of
    :data:`PRESETS`), with ``overrides`` of its arguments (a cut depth)."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; one of {sorted(PRESETS)}")
    return make_clip_state_dict(**{**PRESETS[name], **overrides}, context_length=77,
                                vocab_size=49408, seed=seed)


def make_clip_state_dict(vision_width=64, vision_layers=3, patch_size=8, image_resolution=32,
                         text_width=64, text_layers=2, context_length=77, vocab_size=49408,
                         embed_dim=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.02
    sd = {}
    sd["visual.conv1.weight"] = r(vision_width, 3, patch_size, patch_size)
    sd["visual.class_embedding"] = r(vision_width)
    n_patches = (image_resolution // patch_size) ** 2
    sd["visual.positional_embedding"] = r(n_patches + 1, vision_width)
    for pre in ["visual.ln_pre", "visual.ln_post"]:
        sd[f"{pre}.weight"] = torch.ones(vision_width)
        sd[f"{pre}.bias"] = torch.zeros(vision_width)

    def block(prefix, width):
        sd[f"{prefix}.ln_1.weight"] = torch.ones(width)
        sd[f"{prefix}.ln_1.bias"] = torch.zeros(width)
        sd[f"{prefix}.ln_2.weight"] = torch.ones(width)
        sd[f"{prefix}.ln_2.bias"] = torch.zeros(width)
        sd[f"{prefix}.attn.in_proj_weight"] = r(3 * width, width)
        sd[f"{prefix}.attn.in_proj_bias"] = torch.zeros(3 * width)
        sd[f"{prefix}.attn.out_proj.weight"] = r(width, width)
        sd[f"{prefix}.attn.out_proj.bias"] = torch.zeros(width)
        sd[f"{prefix}.mlp.c_fc.weight"] = r(4 * width, width)
        sd[f"{prefix}.mlp.c_fc.bias"] = torch.zeros(4 * width)
        sd[f"{prefix}.mlp.c_proj.weight"] = r(width, 4 * width)
        sd[f"{prefix}.mlp.c_proj.bias"] = torch.zeros(width)

    for i in range(vision_layers):
        block(f"visual.transformer.resblocks.{i}", vision_width)
    sd["visual.proj"] = r(vision_width, embed_dim)

    sd["token_embedding.weight"] = r(vocab_size, text_width)
    sd["positional_embedding"] = r(context_length, text_width)
    for i in range(text_layers):
        block(f"transformer.resblocks.{i}", text_width)
    sd["ln_final.weight"] = torch.ones(text_width)
    sd["ln_final.bias"] = torch.zeros(text_width)
    sd["text_projection"] = r(text_width, embed_dim)
    return sd


def make_rn_state_dict(width=16, layers=(1, 1, 1, 1), image_resolution=64, embed_dim=32,
                       text_width=64, text_layers=2, context_length=12, vocab_size=100, seed=0):
    """An RN50-architecture CLIP checkpoint (a ModifiedResNet image tower)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.05
    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = torch.ones(c)
        sd[f"{prefix}.bias"] = torch.zeros(c)
        sd[f"{prefix}.running_mean"] = 0.1 * r(c)
        sd[f"{prefix}.running_var"] = torch.ones(c)

    sd["visual.conv1.weight"] = r(width // 2, 3, 3, 3)
    bn("visual.bn1", width // 2)
    sd["visual.conv2.weight"] = r(width // 2, width // 2, 3, 3)
    bn("visual.bn2", width // 2)
    sd["visual.conv3.weight"] = r(width, width // 2, 3, 3)
    bn("visual.bn3", width)

    inplanes = width
    for stage, (mult, blocks) in enumerate(zip((1, 2, 4, 8), layers), start=1):
        planes = width * mult
        for b in range(blocks):
            pre = f"visual.layer{stage}.{b}"
            sd[f"{pre}.conv1.weight"] = r(planes, inplanes, 1, 1)
            bn(f"{pre}.bn1", planes)
            sd[f"{pre}.conv2.weight"] = r(planes, planes, 3, 3)
            bn(f"{pre}.bn2", planes)
            sd[f"{pre}.conv3.weight"] = r(planes * 4, planes, 1, 1)
            bn(f"{pre}.bn3", planes * 4)
            stride = 2 if (stage > 1 and b == 0) else 1
            if stride > 1 or inplanes != planes * 4:
                sd[f"{pre}.downsample.0.weight"] = r(planes * 4, inplanes, 1, 1)
                bn(f"{pre}.downsample.1", planes * 4)
            inplanes = planes * 4

    embed = width * 32
    spacial = image_resolution // 32
    sd["visual.attnpool.positional_embedding"] = r(spacial ** 2 + 1, embed)
    for name, out in (("q_proj", embed), ("k_proj", embed), ("v_proj", embed),
                      ("c_proj", embed_dim)):
        sd[f"visual.attnpool.{name}.weight"] = r(out, embed)
        sd[f"visual.attnpool.{name}.bias"] = 0.1 * r(out)

    # the text tower, so that the text and "all" loads work
    sd["token_embedding.weight"] = r(vocab_size, text_width)
    sd["positional_embedding"] = r(context_length, text_width)
    for i in range(text_layers):
        p = f"transformer.resblocks.{i}"
        sd[f"{p}.ln_1.weight"] = torch.ones(text_width)
        sd[f"{p}.ln_1.bias"] = torch.zeros(text_width)
        sd[f"{p}.ln_2.weight"] = torch.ones(text_width)
        sd[f"{p}.ln_2.bias"] = torch.zeros(text_width)
        sd[f"{p}.attn.in_proj_weight"] = r(3 * text_width, text_width)
        sd[f"{p}.attn.in_proj_bias"] = torch.zeros(3 * text_width)
        sd[f"{p}.attn.out_proj.weight"] = r(text_width, text_width)
        sd[f"{p}.attn.out_proj.bias"] = torch.zeros(text_width)
        sd[f"{p}.mlp.c_fc.weight"] = r(4 * text_width, text_width)
        sd[f"{p}.mlp.c_fc.bias"] = torch.zeros(4 * text_width)
        sd[f"{p}.mlp.c_proj.weight"] = r(text_width, 4 * text_width)
        sd[f"{p}.mlp.c_proj.bias"] = torch.zeros(text_width)
    sd["ln_final.weight"] = torch.ones(text_width)
    sd["ln_final.bias"] = torch.zeros(text_width)
    sd["text_projection"] = r(text_width, embed_dim)
    return sd


def make_eva_state_dict(width=64, layers=2, patch_size=14, image_resolution=42,
                        mlp_ratio=2.6667, embed_dim=48, seed=0):
    """An EVA-02-CLIP vision tower in EVA-CLIP's key layout (``visual.*``:
    separate q, k, v projections with q and v biases, the sub-LNs
    ``attn.inner_attn_ln`` and ``mlp.ffn_ln``, SwiGLU ``mlp.w1`` / ``w2`` /
    ``w3`` of width ``int(width · mlp_ratio)``, ``norm`` and ``head``), by
    EVA's init (weights N(0, 0.02), LayerNorms 1 / 0), with small random
    biases so that every bias reaches the tower; no text tower."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, std=0.02: torch.randn(*s, generator=g) * std
    hidden = int(width * mlp_ratio)
    grid = image_resolution // patch_size
    sd = {"visual.patch_embed.proj.weight": r(width, 3, patch_size, patch_size),
          "visual.patch_embed.proj.bias": r(width),
          "visual.cls_token": r(1, 1, width), "visual.pos_embed": r(1, grid * grid + 1, width),
          "visual.norm.weight": torch.ones(width), "visual.norm.bias": torch.zeros(width),
          "visual.head.weight": r(embed_dim, width), "visual.head.bias": r(embed_dim)}
    for i in range(layers):
        p = f"visual.blocks.{i}."
        for ln, n in (("norm1", width), ("attn.inner_attn_ln", width), ("norm2", width),
                      ("mlp.ffn_ln", hidden)):
            sd[f"{p}{ln}.weight"] = 1.0 + r(n, std=0.1)
            sd[f"{p}{ln}.bias"] = r(n, std=0.1)
        for n in "qkv":
            sd[f"{p}attn.{n}_proj.weight"] = r(width, width)
        sd[p + "attn.q_bias"], sd[p + "attn.v_bias"] = r(width), r(width)
        sd[p + "attn.proj.weight"], sd[p + "attn.proj.bias"] = r(width, width), r(width)
        for n in ("w1", "w2"):
            sd[f"{p}mlp.{n}.weight"], sd[f"{p}mlp.{n}.bias"] = r(hidden, width), r(hidden)
        sd[p + "mlp.w3.weight"], sd[p + "mlp.w3.bias"] = r(width, hidden), r(width)
    return sd


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="a published geometry; the flags below override its values")
    # None: the preset's value, or without a preset the tiny default
    p.add_argument("--vision-width", type=int)
    p.add_argument("--vision-layers", type=int)
    p.add_argument("--patch-size", type=int)
    p.add_argument("--image-resolution", type=int)
    p.add_argument("--text-width", type=int)
    p.add_argument("--text-layers", type=int)
    p.add_argument("--context-length", type=int)
    p.add_argument("--vocab-size", type=int)
    p.add_argument("--embed-dim", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eva", action="store_true",
                   help="an EVA-02-CLIP vision tower (EVA-CLIP's layout) of --vision-width, "
                        "--vision-layers, --patch-size, --image-resolution, --embed-dim")
    args = p.parse_args(argv)

    given = {k: v for k, v in vars(args).items()
             if k not in ("out", "preset", "seed", "eva") and v is not None}
    if args.eva:
        names = {"vision_width": "width", "vision_layers": "layers", "patch_size": "patch_size",
                 "image_resolution": "image_resolution", "embed_dim": "embed_dim"}
        sd = make_eva_state_dict(**{names[k]: v for k, v in given.items() if k in names},
                                 seed=args.seed)
    elif args.preset is not None:
        sd = preset_state_dict(args.preset, args.seed, **given)
    else:
        sd = make_clip_state_dict(**given, seed=args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(sd, args.out)
    print(f"wrote {args.out} ({sum(v.numel() for v in sd.values())} params)")


if __name__ == "__main__":
    main()
