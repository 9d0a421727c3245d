"""The port's ViTKD loss against the JAX package, on the CPU.

The JAX module initialises its variables; they cross to the port through
``convert.jax_loss_aux_to_torch`` (the generation convolutions' kernels go
from ``[3, 3, in, out]`` on NHWC tokens to ``[out, in, 3, 3]`` on NCHW).  Both
then see the same numpy-seeded representations and the same token mask: the
JAX package's ``random_masking`` is patched to return a numpy-seeded mask and
the port's forward is handed that mask.  Loss and gradients within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.losses import vit_kd as jax_vit_kd
from distillclip_tpu_torch.convert import jax_loss_aux_to_torch, torch_name_to_jax_path
from distillclip_tpu_torch.losses.vit_kd import ViTKDLoss, random_masking

B, N, LOW, HIGH = 4, 17, 2, 2          # 16 = 4 x 4 patch tokens and the cls token


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _setup(monkeypatch, s_dim, t_dim, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    preds_s = [n(B, LOW, N, s_dim), n(B, HIGH, N, s_dim)]
    preds_t = [n(B, LOW, N, t_dim), n(B, HIGH, N, t_dim)]
    masks = [(rng.random((B, N - 1)) < 0.5).astype(np.float32) for _ in range(HIGH)]
    queue = []
    monkeypatch.setattr(jax_vit_kd, "random_masking",
                        lambda rng, x, ratio: jnp.asarray(queue.pop(0), x.dtype))
    para = dict(student_dims=s_dim, teacher_dims=t_dim, low_layers_num=LOW,
                high_layers_num=HIGH)
    jmod = jax_vit_kd.ViTKDLoss(**para)
    js, jt = [jnp.asarray(a) for a in preds_s], [jnp.asarray(a) for a in preds_t]
    queue.extend(masks)
    variables = jmod.init({"params": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)},
                          js, jt)
    # a mask token of zeros would hide a wrong broadcast
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["mask_token"] = n(1, 1, t_dim) * 0.1

    def jloss(p, s0, s1):
        queue.extend(masks)
        return jmod.apply({"params": p}, [s0, s1], jt, rngs={"mask": jax.random.PRNGKey(3)})

    return para, params, jloss, js, preds_s, preds_t, masks


@pytest.mark.parametrize("s_dim,t_dim", [(8, 8), (6, 8)], ids=["same_width", "aligned"])
def test_vit_kd_matches_jax_with_the_same_mask(s_dim, t_dim, monkeypatch):
    para, jparams, jloss, js, preds_s, preds_t, masks = _setup(monkeypatch, s_dim, t_dim)
    jval, (jg, jgs0, jgs1) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jparams, *js)

    mod = ViTKDLoss(**para)
    state = {k[len("loss_aux."):]: v for k, v in jax_loss_aux_to_torch(jparams).items()}
    assert set(state) == {k for k, _ in mod.named_parameters()}
    has_align = any(k.startswith("align_") for k in state)
    assert has_align == (s_dim != t_dim)
    leaves = {k: v.clone().requires_grad_() for k, v in state.items()}
    ts = [torch.from_numpy(a).requires_grad_() for a in preds_s]
    val = torch.func.functional_call(
        mod, leaves, (ts, [torch.from_numpy(a) for a in preds_t], None,
                      [torch.from_numpy(m) for m in masks]))
    assert abs(float(val.detach()) - float(jval)) <= 1e-5 * abs(float(jval))
    grads = torch.autograd.grad(val, list(leaves.values()) + ts)
    ref = _flat(jg)
    for name, g in zip(leaves, grads):
        r = ref[torch_name_to_jax_path("loss_aux." + name)[len("loss_aux/"):]]
        if name.endswith(".weight"):               # OIHW here, HWIO there
            r = r.transpose(3, 2, 0, 1)
        assert g.shape == r.shape, name
        assert np.abs(g.numpy() - r).max() <= 1e-5 * max(np.abs(r).max(), 1e-8), name
    for g, r in zip(grads[len(leaves):], (jgs0, jgs1)):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-5 * np.abs(np.asarray(r)).max()


def test_vit_kd_takes_bf16_representations_in_fp32(monkeypatch):
    para, jparams, jloss, js, preds_s, preds_t, masks = _setup(monkeypatch, 8, 8, seed=1)
    mod = ViTKDLoss(**para)
    state = {k[len("loss_aux."):]: v for k, v in jax_loss_aux_to_torch(jparams).items()}
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    val = torch.func.functional_call(
        mod, state, ([bf(a) for a in preds_s], [torch.from_numpy(a) for a in preds_t], None,
                     [torch.from_numpy(m) for m in masks]))
    jval = jloss(jparams, *[a.astype(jnp.bfloat16) for a in js])
    assert val.dtype == torch.float32
    assert abs(float(val) - float(jval)) <= 1e-4 * abs(float(jval))


@pytest.mark.parametrize("ratio", [0.5, 0.75, 0.1])
def test_random_masking_keeps_exactly_len_keep_tokens_per_sample(ratio):
    x = torch.zeros(8, 16, 4)
    gen = torch.Generator().manual_seed(0)
    mask = random_masking(x, ratio, gen)
    jmask = np.asarray(jax_vit_kd.random_masking(jax.random.PRNGKey(0), jnp.zeros((8, 16, 4)),
                                                 ratio))
    keep = int(16 * (1 - ratio))
    assert mask.shape == (8, 16) and set(mask.unique().tolist()) <= {0.0, 1.0}
    assert (mask.sum(dim=1) == 16 - keep).all() and (jmask.sum(axis=1) == 16 - keep).all()
    again = random_masking(x, ratio, torch.Generator().manual_seed(0))
    other = random_masking(x, ratio, torch.Generator().manual_seed(1))
    assert torch.equal(mask, again) and not torch.equal(mask, other)
    # every token is masked about `ratio` of the time
    many = torch.stack([random_masking(torch.zeros(64, 16, 1), ratio, gen) for _ in range(20)])
    assert abs(float(many.mean()) - (16 - keep) / 16) < 1e-6
    assert float(many.mean(dim=(0, 1)).std()) < 0.05


def test_the_generator_draws_the_mask_and_the_given_mask_overrides_it():
    rng = np.random.default_rng(2)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    mod = ViTKDLoss(8, 8, low_layers_num=1, high_layers_num=1)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)) * 0.1)
    ps, pt = [n(B, 1, N, 8), n(B, 1, N, 8)], [n(B, 1, N, 8), n(B, 1, N, 8)]
    a = mod(ps, pt, torch.Generator().manual_seed(5))
    b = mod(ps, pt, torch.Generator().manual_seed(5))
    c = mod(ps, pt, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    mask = random_masking(ps[1][:, 0, 1:], 0.5, torch.Generator().manual_seed(5))
    assert torch.equal(mod(ps, pt, None, [mask]), a)
