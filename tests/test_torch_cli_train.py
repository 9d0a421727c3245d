"""The port's ``fit`` / ``validate`` / ``lr_find`` through ``cli.main`` on a
shrunken ``configs/smoke_text.yaml``, on the CPU: exit codes, the files a run
leaves, the printed results, and the usage errors."""

import json

import pytest
import torch
import yaml

from distillclip_tpu_torch import cli
from distillclip_tpu_torch.tools.fabricate_teacher import make_clip_state_dict


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    ckpt = root / "tiny_clip.pt"
    torch.save(make_clip_state_dict(), str(ckpt))
    with open("configs/smoke_text.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["init_args"]["teacher_name"] = str(ckpt)
    cfg["data"]["init_args"]["dataset_para"]["size"] = 32
    cfg["data"]["init_args"].update(train_batch_size=16, val_batch_size=16)
    cfg["trainer"].update(max_epochs=2, save_every_n_steps=2, profiler="simple")
    cfg["trainer"]["logger"]["init_args"]["dir"] = str(root / "result")
    path = root / "smoke.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return {"root": root, "config": str(path), "run": root / "result" / "smoke-text"}



def test_fit_writes_the_run(smoke, capsys):
    assert cli.main(["fit", "-c", smoke["config"], "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["summary"]
    assert "val_stu_acc/stu_acc_top1" in summary
    run = smoke["run"]
    for name in ("config.yaml", "metrics.jsonl", "hparams.json", "profile.txt",
                 "checkpoints/last", "checkpoints/index.json", "checkpoints/autosave"):
        assert (run / name).exists(), name
    with open(run / "config.yaml") as f:
        assert "perf" in yaml.safe_load(f)
    with open(run / "hparams.json") as f:
        hp = json.load(f)
    assert hp["task"] == "DistillTask" and hp["devices"] == 1 and hp["steps_per_epoch"] == 2
    assert hp["params/total"] == hp["params/student"] > 0
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "train_loss/loss" in r] == [1, 2, 3, 4]
    assert sum("val_loss/loss" in r for r in records) == 2


def test_validate_prints_the_checkpoints_metrics(smoke, capsys):
    last = str(smoke["run"] / "checkpoints" / "last")
    assert cli.main(["validate", "-c", smoke["config"], "--ckpt", last, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    for key in ("loss", "stu_acc_top1", "val_stu_acc/stu_acc_top1", "val_tea_acc/tea_acc_top1"):
        assert key in out
    with open(smoke["run"] / "metrics.jsonl") as f:
        last_val = [json.loads(line) for line in f if "val_loss/loss" in line][-1]
    assert abs(out["loss"] - last_val["val_loss/loss"]) <= 1e-6 * abs(last_val["val_loss/loss"])


def test_lr_find_suggests_a_rate(smoke, capsys):
    assert cli.main(["lr_find", "-c", smoke["config"], "--device", "cpu", "--steps", "6",
                     "--min-lr", "1e-6", "--max-lr", "1e-2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps_run"] == 6 and 1e-6 <= out["suggested_lr"] <= 1e-2


def test_lr_find_without_a_suggestion_exits_1(smoke, capsys):
    # two steps leave too few losses for the suggestion rule
    assert cli.main(["lr_find", "-c", smoke["config"], "--device", "cpu", "--steps", "2"]) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["suggested_lr"] is None


@pytest.mark.parametrize("command", ["fit", "validate", "lr_find"])
def test_trainer_commands_require_a_config(command, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main([command, "--device", "cpu"])
    assert exc.value.code == 2
    assert "requires at least one -c/--config" in capsys.readouterr().err
