"""``fit`` under data parallelism on the CPU: two ranks launched as
``torchrun`` launches them (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` ...,
``--device cpu``: gloo), each with its shard of every epoch, against one
process at twice the batch on the same permutation.  The counterpart of
``tests/test_multihost.py::test_multiprocess_trainer_fit``.

The interleaved shards of a batch of B are, together, the single process's
batch of 2B in another order; the losses and retrieval metrics do not
depend on the order, so they agree to float rounding (1e-5 relative;
accuracies within one sample in N).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
B = 8


def _overlay(tmp_path, teacher, name, batch):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump({
        "model": {"init_args": {"teacher_name": teacher, "compute_dtype": "float32"}},
        "data": {"init_args": {"train_batch_size": batch, "val_batch_size": batch,
                               "num_workers": 1}},
        "trainer": {"logger": {"init_args": {"dir": str(tmp_path / name)}}}}))
    return str(path)


def _fit(tmp_path, teacher, name, batch, procs):
    """Run ``cli fit`` on ``procs`` processes; the run directory."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-c", "import torch; torch.set_num_threads(1); "
           "from distillclip_tpu_torch import cli; raise SystemExit(cli.main())",
           "fit", "-c", "configs/smoke_dual.yaml", "-c", _overlay(tmp_path, teacher, name, batch),
           "--device", "cpu"]
    procs_ = []
    for r in range(procs):
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        if procs > 1:
            env.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(procs),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs_.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
    for r, p in enumerate(procs_):
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs_:
                q.kill()
            pytest.fail(f"rank {r} of the fit did not end within {TIMEOUT} s")
        assert p.returncode == 0, f"rank {r}: {out[-3000:]}"
    return tmp_path / name / "smoke-dual"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict

    tmp = tmp_path_factory.mktemp("fit_ddp")
    teacher = str(tmp / "tiny_clip.pt")
    torch.save(make_clip_state_dict(), teacher)
    return _fit(tmp, teacher, "two", B, 2), _fit(tmp, teacher, "one", 2 * B, 1)


def _records(run_dir):
    with open(run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_rank_zero_writes_the_run(runs):
    two, one = runs
    records = _records(two)
    assert len(records) == len(_records(one))     # one writer: no line twice
    assert len([r for r in records if "train_loss/loss" in r]) == 2 * 48 // (2 * B)
    assert (two / "checkpoints" / "last").exists()
    assert json.loads((two / "checkpoints" / "index.json").read_text())["entries"]
    assert json.loads((two / "hparams.json").read_text())["devices"] == 2
    assert json.loads((one / "hparams.json").read_text())["devices"] == 1


def test_losses_and_validation_equal_one_process_at_twice_the_batch(runs):
    two, one = runs
    val_n = 2 * B
    for a, b in zip(_records(two), _records(one)):
        assert a["step"] == b["step"]
        for k, v in b.items():
            if k.startswith(("train_loss/", "val_loss/", "val_stu_score/", "val_tea_score/")):
                assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
            elif k.startswith(("val_stu_acc/", "val_tea_acc/", "val_step/", "val_stu_")):
                assert abs(a[k] - v) <= 1.0 / val_n + 1e-7, k
            elif k == "perf/items_per_s":
                assert a[k] > 0


def test_sharded_prestaged_batches_are_the_host_loader_s():
    """Each rank's DevicePrestagedLoader gives its shard's host batches, and
    the shards of a batch are the single loader's batch of twice the size."""
    from distillclip_tpu_torch.data.component.synthetic import SyntheticPairDataset
    from distillclip_tpu_torch.data.datamodule import DevicePrestagedLoader
    from distillclip_tpu_torch.data.loader import DataLoader

    ds = SyntheticPairDataset(size=40, image_size=8, context_length=6, vocab_size=50)
    whole = DataLoader(ds, batch_size=2 * B, shuffle=True, seed=3, num_threads=1)
    shards = [DataLoader(ds, batch_size=B, shuffle=True, seed=3, num_threads=1,
                         num_shards=2, shard_index=r) for r in range(2)]
    staged = [DevicePrestagedLoader(s, "cpu") for s in shards]
    for epoch in range(2):
        whole.set_epoch(epoch)
        for s in staged:
            s.set_epoch(epoch)
        got = [list(s) for s in staged]
        for r, (loader, batches) in enumerate(zip(shards, got)):
            for a, b in zip(batches, loader):
                for k in a:
                    np.testing.assert_array_equal(a[k].numpy(), b[k])
        for i, w in enumerate(whole):
            rows = np.concatenate([got[0][i]["tokens"].numpy(), got[1][i]["tokens"].numpy()])
            assert sorted(map(bytes, rows)) == sorted(map(bytes, w["tokens"]))


# Two gloo ranks whose process group times out after 10 s: the first rank's
# work takes 12 s (it succeeds, then it fails), and then a plain barrier
# meets the same 12 s of work on the first rank.
_FIRST_RANK_CHILD = """
import json, sys, time
from datetime import timedelta
import torch
torch.set_num_threads(1)
from distillclip_tpu_torch.parallel import distributed as D

D._TIMEOUT = timedelta(seconds=10)
D.initialize_distributed("cpu")
out = {}

def work(fails):
    time.sleep(12)
    if fails:
        raise ValueError("the corpus is missing")

for case, fails in (("outlasts", False), ("fails", True)):
    try:
        D.on_first_rank(lambda: work(fails))
        out[case] = "ok"
    except Exception as e:
        out[case] = f"{type(e).__name__}: {e}"
try:
    if D.is_main():
        time.sleep(12)
    D.barrier()
    out["barrier"] = "ok"
except Exception as e:
    out["barrier"] = f"{type(e).__name__}: {e}"
print(json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def first_rank_outcomes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FIRST_RANK_CHILD], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1", "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        for r in range(2)]
    outcomes = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} did not end within {TIMEOUT} s")
        assert p.returncode == 0, f"rank {r}: {out[-3000:]}"
        outcomes.append(json.loads(out.strip().splitlines()[-1]))
    return outcomes


@pytest.mark.parametrize("case,rank0,rank1", [
    ("outlasts", "ok", "ok"),
    ("fails", "ValueError: the corpus is missing",
     "RuntimeError: the first rank failed: ValueError: the corpus is missing"),
])
def test_first_rank_work_outlasts_the_process_group_timeout(first_rank_outcomes, case, rank0,
                                                            rank1):
    """The others wait for the first rank's prepare however long it takes,
    and hear of its failure."""
    assert [o[case] for o in first_rank_outcomes] == [rank0, rank1]


def test_a_plain_barrier_times_out_on_the_same_work(first_rank_outcomes):
    """The control: a collective of the process group gives up on the
    waiting rank."""
    assert "Timed out" in first_rank_outcomes[1]["barrier"]
