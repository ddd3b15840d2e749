"""Run directory and logger of the commands (deepsir_tpu/utils/logging.py).

`prepare_logger` makes the run directory (`<logdir>/<stamp>[_<name>]`, or
`<logdir>/logdev`, wiped first, under `dev`), logs to the console and to
its `log.txt`, records the command, the source commit and the working
diff (`compareHead.diff`) where git can tell them, and writes the config
as `config.json`: `config.config_dict(cfg)`, which is the JAX package's for
the same flags unless a port-only option is set, so that either package's
readers read the run.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import subprocess
import sys
from datetime import datetime
from typing import Optional, Sequence, Tuple

from deepsir_tpu_torch.config import Config, config_dict


def _git_info(log_dir: str) -> Optional[str]:
    """HEAD's sha, with the working diff written into log_dir; None outside
    a git checkout."""
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             check=True, timeout=30).stdout.strip()
        diff = subprocess.run(["git", "diff"], capture_output=True, text=True,
                              timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    with open(os.path.join(log_dir, "compareHead.diff"), "w") as fid:
        fid.write(diff)
    return sha


def prepare_logger(cfg, log_path: Optional[str] = None,
                   argv: Optional[Sequence[str]] = None) -> Tuple[logging.Logger, str]:
    """Create the run directory and install the console and file handlers.

    cfg: a Config (or any object with logdir, dev and name). `argv` is the
    command logged (default sys.argv). A later call in the same process
    closes the file handler of the one before. Returns (logger, log_path).
    """
    if log_path is None:
        if getattr(cfg, "dev", False):
            log_path = os.path.join(getattr(cfg, "logdir", "./logs"), "logdev")
            shutil.rmtree(log_path, ignore_errors=True)
        else:
            stamp = datetime.now().strftime("%y%m%d_%H%M%S")
            name = getattr(cfg, "name", None)
            log_path = os.path.join(cfg.logdir, f"{stamp}_{name}" if name else stamp)
    os.makedirs(log_path, exist_ok=True)

    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    if not any(isinstance(h, logging.StreamHandler) and h.stream is sys.stdout
               for h in logger.handlers):
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(fmt)
        logger.addHandler(console)
    for handler in [h for h in logger.handlers if getattr(h, "_run_log", False)]:
        logger.removeHandler(handler)
        handler.close()
    file_handler = logging.FileHandler(os.path.join(log_path, "log.txt"), mode="a")
    file_handler.setFormatter(fmt)
    file_handler._run_log = True
    logger.addHandler(file_handler)

    logger.info("Command: %s", " ".join(sys.argv if argv is None else argv))
    sha = _git_info(log_path)
    if sha:
        logger.info("Source commit: %s", sha[:12])
    if dataclasses.is_dataclass(cfg):
        tree = config_dict(cfg) if isinstance(cfg, Config) else dataclasses.asdict(cfg)
        cfg_json = json.dumps(tree, indent=2, default=str)
        with open(os.path.join(log_path, "config.json"), "w") as fid:
            fid.write(cfg_json)
        logger.info("Config:\n%s", cfg_json)
    logger.info("Output and logs will be saved to: %s", log_path)
    return logger, log_path


def snapshot_source(log_path: str, package_root: Optional[str] = None) -> None:
    """Copy the package's source into `<log_path>/code/` (no caches, no
    built kernels), once per run directory."""
    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(log_path, "code", os.path.basename(package_root))
    if os.path.exists(dst):
        return
    shutil.copytree(package_root, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so", "_build"))
