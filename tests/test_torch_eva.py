"""The EVA-02-CLIP teacher of the port (``models/eva_vit.py``) on the CPU at a
tiny size: its tower against the benchmark's plain reference
(``benchmark/reference/eva.py``) on seeded weights, the mapping of EVA-CLIP's
state dict (q, k, v fused, W1 and W2 interleaved, the SwiGLU width padded),
each mechanism left out or altered failing the comparison, the loader, and
the fit overlay ``configs/eva02_image.yaml``.

Tolerances: the tower runs in fp32 here, and the reference in fp32 computes
the same functions in another order (LN folded into the products' operands,
the padded hidden width), so the rows agree to ~1e-6; each mechanism control
moves them by more than 1e-3 at this size, so 1e-4 tells them apart."""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import eva as RE
from benchmark.reference.numerics import Precision
from distillclip_tpu_torch.models.eva_vit import (
    EvaVisionTransformer,
    interleave,
    map_eva_visual_weights,
    padded,
    rope_table,
)
from distillclip_tpu_torch.models.outputs import ControlFlags
from distillclip_tpu_torch.models.teacher import load_text_teacher, teacher_load
from distillclip_tpu_torch.serving.inputs import prepare_inputs
from distillclip_tpu_torch.tools.fabricate_teacher import make_eva_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# width 64 in 4 heads of 16, 42 px in patches of 14 (a 3 × 3 grid and the
# class token), SwiGLU hidden int(64 · 2.6667) = 170, padded to 192
WIDTH, HEADS, RES, PATCH, LAYERS, OUT = 64, 4, 42, 14, 2, 48
HIDDEN = int(WIDTH * 2.6667)
TOL = 1e-4


def _rows_gap(a, b):
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


@pytest.fixture(scope="module")
def tiny():
    sd = make_eva_state_dict(width=WIDTH, layers=LAYERS, patch_size=PATCH,
                             image_resolution=RES, embed_dim=OUT, seed=3)
    tower = EvaVisionTransformer(RES, PATCH, WIDTH, LAYERS, HEADS, HIDDEN, OUT)
    tower.load_state_dict(map_eva_visual_weights(sd, LAYERS))
    images = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, RES, RES, 3),
                                                                dtype=np.uint8))
    with torch.no_grad():
        out = tower(prepare_inputs(images, torch.float32))
    return sd, images, out


def test_tower_matches_the_plain_reference(tiny):
    sd, images, out = tiny
    assert HIDDEN == 170 and padded(HIDDEN) == 192
    assert _rows_gap(out, RE.eva_image(sd, images, Precision(), HEADS)) < TOL


@pytest.mark.parametrize("variant", RE.VARIANTS)
def test_each_mechanism_control_fails_the_comparison(tiny, variant):
    sd, images, out = tiny
    assert _rows_gap(out, RE.eva_image(sd, images, Precision(), HEADS, variant=variant)) > 10 * TOL


def test_state_dict_mapping_fuses_interleaves_pads_and_round_trips(tiny):
    sd = tiny[0]
    p = map_eva_visual_weights(sd, LAYERS)
    blk, v = "blocks.1.", lambda k: sd["visual." + k]
    qkv = p[blk + "qkv.kernel"]
    assert qkv.shape == (WIDTH, 3 * WIDTH)
    assert torch.equal(p[blk + "qkv.bias"][WIDTH:2 * WIDTH], torch.zeros(WIDTH))   # no k bias
    w12, b12 = p[blk + "w12.kernel"], p[blk + "w12.bias"]
    assert w12.shape == (WIDTH, 2 * 192) and b12.shape == (2 * 192,)
    assert torch.equal(w12[:, 6], v(blk + "mlp.w1.weight")[3]) and torch.equal(
        w12[:, 7], v(blk + "mlp.w2.weight")[3])
    assert not w12[:, 2 * HIDDEN:].any() and not b12[2 * HIDDEN:].any()
    assert not p[blk + "ffn_ln.scale"][HIDDEN:].any()
    assert not p[blk + "ffn_ln.bias"][HIDDEN:].any()
    assert p[blk + "w3.kernel"].shape == (192, WIDTH) and not p[blk + "w3.kernel"][HIDDEN:].any()
    assert torch.equal(interleave(torch.tensor([1, 2]), torch.tensor([3, 4])),
                       torch.tensor([1, 3, 2, 4]))
    # back to EVA-CLIP's layout
    back = {"mlp.w1.weight": w12[:, 0::2][:, :HIDDEN].t(),
            "mlp.w2.weight": w12[:, 1::2][:, :HIDDEN].t(),
            "mlp.w1.bias": b12[0::2][:HIDDEN], "mlp.w2.bias": b12[1::2][:HIDDEN],
            "mlp.ffn_ln.weight": p[blk + "ffn_ln.scale"][:HIDDEN],
            "mlp.w3.weight": p[blk + "w3.kernel"][:HIDDEN].t(),
            "attn.q_proj.weight": qkv[:, :WIDTH].t(),
            "attn.k_proj.weight": qkv[:, WIDTH:2 * WIDTH].t(),
            "attn.v_proj.weight": qkv[:, 2 * WIDTH:].t(),
            "attn.q_bias": p[blk + "qkv.bias"][:WIDTH],
            "attn.v_bias": p[blk + "qkv.bias"][2 * WIDTH:]}
    for k, t in back.items():
        assert torch.equal(t, v(blk + k)), k
    conv = v("patch_embed.proj.weight")
    assert torch.equal(p["patch_kernel"].reshape(PATCH, PATCH, 3, WIDTH).permute(3, 2, 0, 1), conv)


def test_tower_at_257_tokens_matches_the_plain_reference():
    """Past 256 tokens (a 16 × 16 grid and the class token) the tower's
    attention takes the long-row route (its plain version here), two heads of
    64, against the reference's own attention."""
    width, heads, res, layers = 128, 2, 224, 2
    sd = make_eva_state_dict(width=width, layers=layers, patch_size=PATCH,
                             image_resolution=res, embed_dim=OUT, seed=4)
    tower = EvaVisionTransformer(res, PATCH, width, layers, heads, int(width * 2.6667), OUT)
    tower.load_state_dict(map_eva_visual_weights(sd, layers))
    images = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (3, res, res, 3),
                                                                dtype=np.uint8))
    with torch.no_grad():
        out = tower(prepare_inputs(images, torch.float32))
    assert tower.pos_embed.shape[0] == 257
    assert _rows_gap(out, RE.eva_image(sd, images, Precision(), heads)) < TOL


@pytest.mark.parametrize("seq,route", [(10, "plain_attention_rows_qkv"),
                                       (256, "plain_attention_rows_qkv"),
                                       (257, "plain_attention_long"),
                                       (577, "plain_attention_long")])
def test_attention_route_is_chosen_by_the_sequence_length(monkeypatch, seq, route):
    """#13 up to 256 tokens, the long-row kernel past it; nothing else."""
    from distillclip_tpu_torch.models import eva_vit

    calls = []
    for name in ("plain_attention_rows_qkv", "plain_attention_long"):
        monkeypatch.setattr(eva_vit, name, lambda qkv, *, heads, seq, n=name:
                            calls.append((n, heads, seq)) or qkv[:, :qkv.shape[1] // 3])
    qkv = torch.zeros(2 * seq, 3 * 2 * 64)
    assert eva_vit._attend(qkv, 2, seq).shape == (2 * seq, 2 * 64)
    assert calls == [(route, 2, seq)]


def test_rope_table_is_the_references_angles():
    table = rope_table(3, 16)
    angles = RE.rotary_angles(3, 16)
    assert torch.allclose(table[..., 0], angles[:, 0::2].cos().float(), atol=1e-6)
    assert torch.allclose(table[..., 1], angles[:, 1::2].sin().float(), atol=1e-6)


def test_loader_builds_the_eva_tower_and_refuses_what_it_lacks(tmp_path):
    path = tmp_path / "eva.pt"
    torch.save(make_eva_state_dict(width=128, layers=1, image_resolution=RES), str(path))
    teacher = teacher_load(str(path), model_type="image", device="cpu")
    assert teacher.visual.blocks[0].heads == 2 and teacher.visual.blocks[0].hidden == 341
    images = prepare_inputs(torch.zeros(2, RES, RES, 3, dtype=torch.uint8), torch.float32)
    assert teacher(images).last_representation.shape == (2, 48)
    with pytest.raises(ValueError, match="taps"):
        teacher(images, ControlFlags(need_rep=True))
    with pytest.raises(ValueError, match="teacher_need_layers"):
        teacher_load(str(path), model_type="image", need_layers=[0, 1], device="cpu")
    with pytest.raises(ValueError, match="text tower"):
        load_text_teacher(str(path), device="cpu")


def test_fit_overlay_merges_over_image_yaml_and_trains_a_step(tmp_path):
    from distillclip_tpu_torch.config.loader import instantiate, load_configs
    from distillclip_tpu_torch.training import DistillTask

    cfg = load_configs([os.path.join(REPO, "configs", "final", "image.yaml"),
                        os.path.join(REPO, "configs", "eva02_image.yaml")])
    init = cfg["model"]["init_args"]
    assert init["teacher_need_layers"] is None and init["freeze_embed"] is False
    assert init["student_encoder"]["init_args"]["out_dim"] == 768
    assert init["loss_control_para"]["loss_name"] == ["out_l1", "out_cos"]
    assert cfg["data"]["init_args"]["dataset_para"]["teacher_name"] == init["teacher_name"]
    assert cfg["data"]["init_args"]["train_batch_size"] == 1024
    path = tmp_path / "eva.pt"
    torch.save(make_eva_state_dict(width=64, layers=1, image_resolution=224, embed_dim=768),
               str(path))
    init["teacher_name"] = str(path)
    task = instantiate(cfg["model"])
    assert isinstance(task, DistillTask)
    state, tx = task.init_state(0, 1, device="cpu")
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3),
                                                                dtype=np.uint8))
    state, metrics = task.make_train_step(tx)(state, images)
    assert np.isfinite(float(metrics["loss"]))
    encode = task.make_teacher_encode("cpu")
    assert encode(images).shape == (2, 768)
