"""Experiment orchestration: grid runner, config merger, scaffolders, templates.

Port of ``distillclip_tpu/tools/experiments.py``, the equivalents of the
reference's sh/ toolkit:

* ``run``      — sh/run.py:19-73: run experiment/version grids, each version
                 = ``python -m distillclip_tpu_torch.cli fit -c <ex>/share.yaml
                 -c <ex>/version_N/version.yaml --device <--device>`` (the
                 card unless ``--device cpu``).
                 Modes: --all_ex / --all_ver / single (-e -v) / range
                 (-b/-t) / list (-n ...).
* ``merge``    — sh/ex.py:16-49: merge share+version into final.yaml.
* ``scaffold`` — sh/structure.py:25-45: create an experiment tree with
                 share.yaml, version_N/version.yaml and description files.
* ``template`` — sh/gene_template.py:15-112: emit trainer templates:
                 train ('t'), profiler simple/advanced ('bs'/'ba'; 'ba' is
                 the torch.profiler trace), lr-range probe ('l').

    python -m distillclip_tpu_torch.tools.experiments run -e my_ex --all_ver
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import yaml


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------


def run_version(ex_name: str, ver_name: str, config_path: Path, other: str = "",
                dry_run: bool = False, device: str = "cuda") -> int:
    ex_path = config_path / ex_name
    share = ex_path / "share.yaml"
    version = ex_path / ver_name / "version.yaml"
    print("=" * 33 + f"Now is Running [{ex_name}] experiment and [{ver_name}]" + "=" * 33)
    cmd = [sys.executable, "-m", "distillclip_tpu_torch.cli", "fit", "-c", str(share),
           "-c", str(version), "--device", device]
    if other:
        cmd += other.split()
    if dry_run:
        print("DRY RUN:", " ".join(cmd))
        rc = 0
    else:
        rc = subprocess.call(cmd)
    print("=" * 34 + f"[{ex_name}] experiment and [{ver_name}] is done!" + "=" * 34 + "\n")
    return rc


def _versions(ex_path: Path):
    return [f for f in sorted(ex_path.iterdir()) if f.is_dir()]


def cmd_run(args) -> int:
    config = Path(args.config)
    run = lambda ex, ver: run_version(ex, ver, config, args.other_para, args.dry_run,
                                      args.device)
    rc = 0
    if args.all_ex:
        for ex_path in (f for f in sorted(config.iterdir()) if f.is_dir()):
            for v in _versions(ex_path):
                rc |= run(ex_path.name, v.name)
    elif args.all_ver and args.ex_name:
        for v in _versions(config / args.ex_name):
            rc |= run(args.ex_name, v.name)
    elif args.ex_name and args.v_num is not None:
        rc = run(args.ex_name, f"version_{args.v_num}")
    elif args.ex_name and (args.begin_ver is not None or args.end_ver is not None):
        vers = _versions(config / args.ex_name)
        begin = args.begin_ver or 0
        end = len(vers) if args.end_ver in (None, -1) else args.end_ver
        assert begin <= len(vers) and len(vers) >= end, (
            f"the begin_ver or end_ver must be smaller than {len(vers)}, got {(begin, end)}"
        )
        for v in vers[begin:end]:
            rc |= run(args.ex_name, v.name)
    elif args.ex_name and args.n_ver:
        vers = _versions(config / args.ex_name)
        for n in args.n_ver:
            if 0 <= int(n) < len(vers):
                rc |= run(args.ex_name, f"version_{n}")
            else:
                print(f"the number of {n} is invalid, the num should in [0, {len(vers)})")
    else:
        print("run: nothing selected (see --help)", file=sys.stderr)
        return 2
    return rc


# ---------------------------------------------------------------------------
# merge (sh/ex.py semantics: one-level-deep section update)
# ---------------------------------------------------------------------------


def generate_config(ex_name: str, version_name: str, config_path: Path):
    with open(config_path / ex_name / "share.yaml", encoding="utf8") as f:
        share = yaml.safe_load(f) or {}
    with open(config_path / ex_name / version_name / "version.yaml", encoding="utf8") as f:
        version = yaml.safe_load(f)
    para = dict(share)
    for k in para:
        if version and k in version:
            para[k].update(version[k])
    return para, config_path / ex_name / version_name


def cmd_merge(args) -> int:
    config = Path(args.config)

    def write(ex, ver):
        para, save_path = generate_config(ex, ver, config)
        with open(save_path / "final.yaml", "w", encoding="utf8") as f:
            f.write(yaml.dump(para))

    if args.all:
        for ex in (d for d in config.iterdir() if d.is_dir()):
            for v in (d for d in ex.iterdir() if d.is_dir()):
                write(ex.name, v.name)
    else:
        write(args.name, args.version)
    return 0


# ---------------------------------------------------------------------------
# scaffold (sh/structure.py)
# ---------------------------------------------------------------------------


def cmd_scaffold(args) -> int:
    config = Path(args.config)
    ex_dir = config / args.ex_name
    ex_dir.mkdir(parents=True, exist_ok=True)
    if args.template and Path(args.template).exists():
        (ex_dir / "share.yaml").write_text(Path(args.template).read_text())
    else:
        (ex_dir / "share.yaml").touch()
    (ex_dir / "desc.txt").write_text("Ex target: \n")
    for i in range(args.v_num):
        vdir = ex_dir / f"version_{i}"
        vdir.mkdir(exist_ok=True)
        (vdir / "version.yaml").touch()
        (vdir / "detail_desc.txt").touch()
    print(f"scaffolded {ex_dir} with {args.v_num} versions")
    return 0


# ---------------------------------------------------------------------------
# template (sh/gene_template.py)
# ---------------------------------------------------------------------------


def trainer_template(target: str) -> dict:
    base = {
        "max_epochs": 50,
        "log_every_n_steps": 100,
        "check_val_every_n_epoch": 1,
        "logger": {
            "class_path": "tensorboard",
            "init_args": {"dir": "./result", "name": "experiment"},
        },
        "callbacks": [
            {"class_path": "LearningRateMonitor"},
            {"class_path": "EarlyStopping", "init_args": {"monitor": "val_loss/loss", "patience": 10}},
        ],
    }
    if target == "t":  # train
        return {"trainer": base}
    if target == "bs":  # bottleneck, simple profiler
        return {"trainer": {**base, "max_epochs": 1, "limit_train_batches": 20,
                            "profiler": "simple"}}
    if target == "ba":  # bottleneck, advanced profiler (torch.profiler trace)
        return {"trainer": {**base, "max_epochs": 1, "limit_train_batches": 20,
                            "profiler": "trace"}}
    if target == "l":  # lr probe: short run sweeping lr via versions
        return {
            "model": {"init_args": {"lr": 1.0e-3}},
            "trainer": {**base, "max_epochs": 3},
        }
    raise ValueError(f"unknown template target {target!r} (use t|bs|ba|l)")


def cmd_template(args) -> int:
    tpl = trainer_template(args.target)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        yaml.safe_dump(tpl, f, sort_keys=False)
    print(f"wrote {out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="distillclip-torch-experiments")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("run", help="run experiment grids")
    r.add_argument("-e", "--ex_name")
    r.add_argument("-v", "--v_num")
    r.add_argument("-c", "--config", default="./config")
    r.add_argument("-b", "--begin_ver", type=int, default=None)
    r.add_argument("-t", "--end_ver", type=int, default=None)
    r.add_argument("--all_ver", action="store_true")
    r.add_argument("--all_ex", action="store_true")
    r.add_argument("-n", "--n_ver", nargs="+")
    r.add_argument("-o", "--other_para", default="")
    r.add_argument("--dry-run", action="store_true")
    r.add_argument("--device", default="cuda", help="each fit's device (cuda or cpu)")
    r.set_defaults(fn=cmd_run)

    m = sub.add_parser("merge", help="merge share+version into final.yaml")
    m.add_argument("-a", "--all", action="store_true")
    m.add_argument("-n", "--name")
    m.add_argument("-v", "--version")
    m.add_argument("-c", "--config", default="./config")
    m.set_defaults(fn=cmd_merge)

    s = sub.add_parser("scaffold", help="create experiment config tree")
    s.add_argument("-e", "--ex_name", required=True)
    s.add_argument("-v", "--v_num", type=int, required=True)
    s.add_argument("-c", "--config", default="./config")
    s.add_argument("-t", "--template", default="./config/template.yaml")
    s.set_defaults(fn=cmd_scaffold)

    t = sub.add_parser("template", help="emit trainer template yaml")
    t.add_argument("target", choices=["t", "bs", "ba", "l"])
    t.add_argument("--out", default="./config/template.yaml")
    t.set_defaults(fn=cmd_template)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
