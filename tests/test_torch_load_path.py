"""Warm-starting stage 3 from stage-1/2 checkpoints (``DualDistillTask``'s
``load_path``) against the JAX package: JAX stage checkpoints of both towers
(Orbax, written by the JAX package) and the same trees in the port's format
(``convert``, then the port's ``save_pytree``); the port's masters are the
saved towers exactly, and equal the JAX task's ``init_params`` after the
converter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distillclip_tpu.models import ControlFlags as JaxFlags
from distillclip_tpu.training.checkpoints import save_pytree as jax_save
from distillclip_tpu_torch.convert import jax_dual_params_to_torch, jax_student_to_torch
from distillclip_tpu_torch.training.checkpoints import nest, save_pytree

from test_teacher import CTX, RES
from test_torch_training import (
    IMAGE_ARGS,
    TEXT_ARGS,
    JaxText,
    JaxVision,
    _jax_task,
    _np_tree,
    _port_task,
    batch,  # noqa: F401  (a fixture)
    ckpt_path,  # noqa: F401  (a fixture)
)


@pytest.fixture(scope="module")
def stage_checkpoints(tmp_path_factory):
    """(JAX load_path, port load_path, the towers' JAX trees): stage-1 and
    stage-2 towers from their own seeds, in each package's format."""
    root = tmp_path_factory.mktemp("stages")
    img = JaxVision(**IMAGE_ARGS).init(jax.random.PRNGKey(3), jnp.zeros((1, RES, RES, 3)),
                                       JaxFlags())["params"]
    txt = JaxText(**TEXT_ARGS).init(jax.random.PRNGKey(4), jnp.ones((1, CTX), jnp.int32),
                                    JaxFlags())["params"]
    jax_paths, port_paths = {}, {}
    for name, tree in (("image", img), ("text", txt)):
        jax_paths[name] = str(root / f"{name}_jax")
        jax_save(jax_paths[name], {"state": {"params": {"student": tree}}})
        port_paths[name] = str(root / f"{name}.pt")
        save_pytree(port_paths[name], {"params": {"student": nest(
            jax_student_to_torch(_np_tree(tree), name))}})
    return jax_paths, port_paths, {"image": img, "text": txt}


def test_load_path_masters_are_the_stage_towers(stage_checkpoints):
    _, port_paths, trees = stage_checkpoints
    seeded = _port_task().init_params(0, "cpu")
    masters = _port_task(load_path=port_paths).init_params(0, "cpu")
    assert set(masters) == set(seeded)
    for name, tree in trees.items():
        want = jax_student_to_torch(_np_tree(tree), name)
        for k, v in want.items():
            got = masters[f"student.{name}_tower.{k}"]
            assert got.dtype == torch.float32 and torch.equal(got, v), (name, k)
    assert any(not torch.equal(masters[k], seeded[k]) for k in masters)


def test_load_path_masters_equal_jax_init_params(stage_checkpoints, ckpt_path, batch):
    jax_paths, port_paths, _ = stage_checkpoints
    ref = _jax_task(ckpt_path, load_path=jax_paths).init_params(
        jax.random.PRNGKey(1), jnp.asarray(batch["tokens"][:1]), jnp.asarray(batch["images"][:1]))
    want = jax_dual_params_to_torch(_np_tree(ref))
    got = _port_task(load_path=port_paths).init_state(0, 1, device="cpu")[0].params
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
