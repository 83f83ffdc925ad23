"""Command line of the port and its multi-job launcher (port of main.py).

    python -m gaot3d_tpu_torch --config FILE   run one config (YAML/TOML/JSON)
    python -m gaot3d_tpu_torch --folder DIR    run every config file under DIR
                                               (recursively), each in a
                                               subprocess; with --debug they
                                               run one after the other in
                                               this process
    --num_works_per_device N   concurrent subprocess jobs a device
    --visible_devices 0 1      jobs go round these devices in turn
                               (CUDA_VISIBLE_DEVICES)
    --device cpu               run every config on this device instead of its
                               `setup.device` (e.g. a config written for the
                               card, on the CPU)

One CSV row a run is appended to `path.database_path`. The job runs on
`setup.device`: the card unless the config says `cpu` or `--device` says
otherwise.
"""
from __future__ import annotations

import argparse
import csv
import logging
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_SUFFIXES = (".toml", ".json", ".yaml", ".yml")


def setup_logging(level: str = "INFO", log_file: Optional[str] = None) -> None:
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    handlers = [logging.StreamHandler()]
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        handlers=handlers,
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m gaot3d_tpu_torch")
    parser.add_argument("-c", "--config", type=str, default=None, help="config file path")
    parser.add_argument("-f", "--folder", type=str, default=None, help="folder of config files")
    parser.add_argument("--debug", action="store_true", help="run configs in-process")
    parser.add_argument("--num_works_per_device", type=int, default=1,
                        help="concurrent subprocess jobs per device")
    parser.add_argument("--visible_devices", nargs="*", type=int, default=None,
                        help="restrict the visible CUDA devices")
    parser.add_argument("--device", type=str, default=None,
                        help="override setup.device of every config (auto, cuda, cuda:N, cpu)")
    parser.add_argument("--log_level", type=str,
                        default=os.environ.get("GAOT_LOG_LEVEL", "INFO"))
    args = parser.parse_args(argv)
    if not (args.config or args.folder):
        parser.error("Please specify --config or --folder")
    if args.config:
        args.arg_files = [args.config]
    else:
        args.arg_files = []
        for root, _dirs, files in os.walk(args.folder):
            for name in sorted(files):
                if name.endswith(CONFIG_SUFFIXES):
                    args.arg_files.append(os.path.join(root, name))
    return args


def append_csv_row(path: str, row: Dict) -> None:
    """Append `row` to the CSV at `path`, the header being the union of the
    columns already there and the row's, in that order; cells a row lacks
    stay empty."""
    rows: List[Dict] = []
    columns: List[str] = []
    if os.path.exists(path):
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            columns = list(reader.fieldnames or [])
            rows = list(reader)
    columns += [k for k in row if k not in columns]
    rows.append(row)
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns, restval="")
        writer.writeheader()
        writer.writerows(rows)
    os.replace(tmp, path)


def run_config_file(path: str, overrides: Optional[dict] = None, return_trainer: bool = False):
    """Run one training or testing job in this process and return its CSV
    datarow, or (datarow, trainer) with `return_trainer`. `overrides` is
    merged onto the loaded config (a nested dict, as in the file)."""
    from .config import load_run_config
    from .train.trainer import init_trainer
    from .utils.dataclass_utils import merge_config

    cfg = load_run_config(path)
    if overrides:
        cfg = merge_config(cfg, overrides)
    # relative output paths are taken from the repo's root
    for attr in ("ckpt_path", "loss_path", "result_path", "database_path"):
        p = getattr(cfg.path, attr)
        if not os.path.isabs(p):
            setattr(cfg.path, attr, os.path.join(REPO_ROOT, p))
        os.makedirs(os.path.dirname(getattr(cfg.path, attr)) or ".", exist_ok=True)

    trainer = init_trainer(cfg)
    trainer.datarow["config"] = path
    trainer.datarow["time"] = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())

    # load priority: artifact > resume path > ckpt flag
    if cfg.setup.resume_from_artifact:
        trainer.load_from_artifact(cfg.setup.resume_from_artifact)
    elif cfg.setup.resume_from_ckpt:
        trainer.load_ckpt(cfg.setup.resume_from_ckpt)
    elif cfg.setup.ckpt and os.path.exists(cfg.path.ckpt_path):
        trainer.load_ckpt()

    if cfg.setup.train:
        trainer.fit()
    elif cfg.setup.test:
        trainer.test()

    append_csv_row(cfg.path.database_path, trainer.datarow)
    return (trainer.datarow, trainer) if return_trainer else trainer.datarow


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging(args.log_level)
    log = logging.getLogger("gaot3d_tpu_torch.cli")

    if args.config or args.debug:
        if args.visible_devices:
            # before the first CUDA call of this process
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(d) for d in args.visible_devices)
        overrides = {"setup": {"device": args.device}} if args.device else None
        for f in args.arg_files:
            log.info("Running config %s", f)
            run_config_file(f, overrides)
        return

    # folder mode: a subprocess a job, so that one failed job does not end the
    # sweep; jobs go round --visible_devices in turn
    pending = list(args.arg_files)
    running = []
    devices = args.visible_devices or [None]
    max_jobs = max(1, args.num_works_per_device) * len(devices)
    launched = 0
    while pending or running:
        while pending and len(running) < max_jobs:
            f = pending.pop(0)
            dev = devices[launched % len(devices)]
            launched += 1
            env = dict(os.environ)
            if dev is not None:
                env["CUDA_VISIBLE_DEVICES"] = str(dev)
            log.info("Launching %s%s", f, f" on device {dev}" if dev is not None else "")
            p = subprocess.Popen(
                [sys.executable, "-m", "gaot3d_tpu_torch", "--config", f, "--debug",
                 "--log_level", str(args.log_level)]
                + (["--device", args.device] if args.device else []), env=env, cwd=REPO_ROOT)
            running.append((f, p))
        time.sleep(1.0)
        still = []
        for f, p in running:
            if p.poll() is None:
                still.append((f, p))
            elif p.returncode != 0:
                log.error("Job %s failed with code %d", f, p.returncode)
            else:
                log.info("Job %s finished", f)
        running = still
