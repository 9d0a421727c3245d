"""``distillclip_tpu_torch.cli score`` against the JAX package's
``distillclip score`` on the same image files, captions and checkpoints, on
the CPU: one JSON line per pair under the same keys, the same images and
captions in the same order, and scores within 2e-2 (the bf16 class: both
score in bf16).  Also the caption-level ``similarity_matrix`` against the JAX
scorer's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from distillclip_tpu import cli as jax_cli
from distillclip_tpu.serving import LCLIPScorer as JaxScorer
from distillclip_tpu_torch import cli
from distillclip_tpu_torch.serving import LCLIPScorer

from test_teacher import RES, _make_state_dict
from test_torch_checkpoints import _cross, jax_stage3  # noqa: F401  (a fixture)

CAPTIONS = ["a cat on a mat", "a dog on grass", "", "sunset over the sea", "two birds"]


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("teacher") / "tiny_clip.pt"
    torch.save(_make_state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Five images of other sizes than the towers' (JPEG and PNG, so both
    decoders' paths run) and a captions file with a blank line."""
    from PIL import Image

    root = tmp_path_factory.mktemp("score")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate([(40, 30), (RES, RES), (25, 50), (64, 48), (33, 33)]):
        arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(images / f"img{i}.{'png' if i == 3 else 'jpg'}")
    captions = root / "captions.txt"
    captions.write_text("\n".join(CAPTIONS) + "\n")
    return str(images), str(captions)


def _lines(capsys, main, argv):
    capsys.readouterr()
    assert main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _assert_same_lines(got, want):
    assert len(got) == len(want) == len([c for c in CAPTIONS if c])
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "caption", "l_clip_score"}
        assert g["image"] == w["image"] and g["caption"] == w["caption"]
        assert abs(g["l_clip_score"]) <= 1.0 + 1e-5
        assert abs(g["l_clip_score"] - w["l_clip_score"]) <= 2e-2


def test_score_with_the_teacher_matches_the_jax_cli(capsys, files, teacher_ckpt):
    images, captions = files
    args = ["score", "--teacher", teacher_ckpt, "--images", images, "--captions", captions]
    got = _lines(capsys, cli.main, args + ["--device", "cpu"])
    want = _lines(capsys, jax_cli.main, args)
    _assert_same_lines(got, want)


def test_score_with_student_checkpoints_matches_the_jax_cli(capsys, files, jax_stage3,
                                                            tmp_path):
    ck, config, _, _ = jax_stage3
    port_ck = _cross(ck, str(tmp_path / "dual.pt"))
    images, captions = files
    tail = ["-c", config, "--images", images, "--captions", captions]
    got = _lines(capsys, cli.main, ["score", "--image-ckpt", port_ck, "--text-ckpt", port_ck,
                                    "--device", "cpu"] + tail)
    want = _lines(capsys, jax_cli.main, ["score", "--image-ckpt", ck, "--text-ckpt", ck] + tail)
    _assert_same_lines(got, want)


def test_score_says_which_tokenizer_and_decoder_ran(capsys, files, teacher_ckpt):
    images, captions = files
    cli.main(["score", "--teacher", teacher_ckpt, "--images", images, "--captions", captions,
              "--device", "cpu"])
    err = capsys.readouterr().err
    assert "tokenizer HashTokenizer" in err and "image decode" in err


def test_score_needs_images_and_captions(capsys, teacher_ckpt):
    assert cli.main(["score", "--teacher", teacher_ckpt, "--device", "cpu"]) == 2
    assert "need --images DIR and --captions FILE" in capsys.readouterr().err


def test_similarity_matrix_takes_captions_as_in_jax(teacher_ckpt):
    """The repaired public signature: images against caption strings."""
    ours = LCLIPScorer.from_teacher(teacher_ckpt, device="cpu")
    ref = JaxScorer.from_teacher(teacher_ckpt)
    images = np.random.default_rng(1).normal(size=(3, RES, RES, 3)).astype(np.float32)
    caps = ["a cat", "a dog on grass", "sunset"]
    got = ours.similarity_matrix(images, caps)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, ref.similarity_matrix(images, caps), atol=2e-2)
    np.testing.assert_allclose(np.diagonal(got), ours.score_arrays(images, caps), atol=1e-6)
    np.testing.assert_allclose(got, ours._similarity_matrix_tokens(images, ours._tokenize(caps)),
                               atol=0)


def test_score_files_raises_on_an_unreadable_file_without_the_native_decoder(
        monkeypatch, files, teacher_ckpt, tmp_path):
    """With no native library (the card's machine) every file goes through
    PIL, and a missing or corrupt file raises, as in the JAX package, instead
    of scoring a zero image."""
    from distillclip_tpu.data import native_loader as jax_loader
    from distillclip_tpu_torch.data import native_loader

    monkeypatch.setattr(native_loader, "load_library", lambda: None)
    monkeypatch.setattr(jax_loader, "load_library", lambda: None)
    ours = LCLIPScorer.from_teacher(teacher_ckpt, device="cpu")
    ref = JaxScorer.from_teacher(teacher_ckpt)
    good = sorted(str(p) for p in Path(files[0]).iterdir())[:3]
    got = ours.score_files(good, CAPTIONS[:3])
    assert got.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.score_files(good, CAPTIONS[:3]), atol=2e-2)
    corrupt = tmp_path / "corrupt.jpg"
    corrupt.write_bytes(b"not an image")
    for bad in ("/nonexistent.jpg", str(corrupt)):
        for scorer in (ours, ref):
            with pytest.raises(OSError):
                scorer.score_files([good[0], bad], CAPTIONS[:2])
