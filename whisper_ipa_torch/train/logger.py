"""Training observability: CSV logs, config snapshot, console contract.

Counterpart of ``whisper_ipa_tpu/train/logger.py`` (the same files,
columns and console line); the hardware snapshot reads torch and
``nvidia-smi`` instead of jax.

Artifacts per run (mirroring the reference's exact files and columns,
scripts/train_whisper_ipa.py:102-178):
  training_config.json, training_log.csv, validation_log.csv,
  training_summary.json

The console line format
``Step N/M | Loss: L | Time: Ts | Samples/sec: S``
is a PARSE CONTRACT consumed by the out-of-process speed monitor
(cli/calculate_real_speed.py) — do not change it.
"""

from __future__ import annotations

import csv
import json
import os
import platform
import resource
from datetime import datetime
from typing import Dict, List, Optional


def get_hardware_info() -> Dict:
    """Hardware snapshot: host + CUDA devices (name and power limit)."""
    import subprocess

    import torch

    info = {
        "platform": platform.platform(),
        "python_version": platform.python_version(),
        "cpu_brand": platform.processor() or "unknown",
        "hw_ncpu": str(os.cpu_count()),
        "torch_version": torch.__version__,
        "num_devices": torch.cuda.device_count(),
        "platform_backend": "cuda" if torch.cuda.is_available() else "cpu",
    }
    if torch.cuda.is_available():
        info["device_kind"] = torch.cuda.get_device_name(0)
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30,
            )
            if smi.returncode == 0:
                info["nvidia_smi"] = smi.stdout.strip().splitlines()
        except (OSError, subprocess.TimeoutExpired):
            pass
    return info


def save_training_config(output_dir: str, args_dict: Dict, hardware: Dict):
    config = {
        "training_args": args_dict,
        "hardware": hardware,
        "start_time": datetime.now().isoformat(),
    }
    with open(os.path.join(output_dir, "training_config.json"), "w") as f:
        json.dump(config, f, indent=2)


class TrainingLogger:
    """CSV-based training logger with separate train/validation logs."""

    TRAIN_COLUMNS = [
        "step", "loss", "lr", "step_time_sec", "samples_per_sec",
        "wall_clock_sec", "timestamp", "peak_memory_mb",
    ]
    VAL_COLUMNS = [
        "step", "per", "pfer", "per_std", "pfer_std",
        "num_samples", "wall_clock_sec", "timestamp",
    ]

    def __init__(self, output_dir: str, write_files: bool = True):
        """write_files=False keeps the in-memory tracking (best-PFER
        state) but writes nothing — non-zero processes on a multi-host
        run use this so CSV rows are not duplicated/raced while the
        best-checkpoint decision stays consistent on every process."""
        self.output_dir = output_dir
        self.write_files = write_files
        self.train_log_path = os.path.join(output_dir, "training_log.csv")
        self.val_log_path = os.path.join(output_dir, "validation_log.csv")
        self.best_pfer = float("inf")
        self.best_pfer_step = 0
        self.latest_val_per: Optional[float] = None
        self.latest_val_pfer: Optional[float] = None
        if write_files:
            self._init_csv(self.train_log_path, self.TRAIN_COLUMNS)
            self._init_csv(self.val_log_path, self.VAL_COLUMNS)

    @staticmethod
    def _init_csv(path: str, columns: List[str]):
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(columns)

    @staticmethod
    def _get_peak_memory_mb() -> float:
        usage = resource.getrusage(resource.RUSAGE_SELF)
        if platform.system() == "Darwin":
            return usage.ru_maxrss / (1024 * 1024)
        return usage.ru_maxrss / 1024  # Linux: KB

    def log_train_step(
        self,
        step: int,
        loss: float,
        lr: float,
        step_time: float,
        batch_size: int,
        wall_clock_sec: float,
    ):
        if not self.write_files:
            return
        with open(self.train_log_path, "a", newline="") as f:
            csv.writer(f).writerow(
                [
                    step,
                    f"{loss:.6f}",
                    f"{lr:.2e}",
                    f"{step_time:.4f}",
                    f"{batch_size / step_time:.2f}",
                    f"{wall_clock_sec:.2f}",
                    datetime.now().isoformat(),
                    f"{self._get_peak_memory_mb():.1f}",
                ]
            )

    def log_validation(
        self, step: int, metrics: Dict, wall_clock_sec: float
    ) -> bool:
        per = metrics["per"]
        pfer = metrics["pfer"]
        self.latest_val_per = per
        self.latest_val_pfer = pfer
        if self.write_files:
            with open(self.val_log_path, "a", newline="") as f:
                csv.writer(f).writerow(
                    [
                        step,
                        f"{per:.4f}",
                        f"{pfer:.4f}",
                        f"{metrics.get('per_std', 0):.4f}",
                        f"{metrics.get('pfer_std', 0):.4f}",
                        metrics.get("num_samples", ""),
                        f"{wall_clock_sec:.2f}",
                        datetime.now().isoformat(),
                    ]
                )
        if pfer < self.best_pfer:
            self.best_pfer = pfer
            self.best_pfer_step = step
            return True
        return False


def console_step_line(
    step: int, num_steps: int, loss: float, step_time: float, batch_size: int
) -> str:
    """The parse-contract console format."""
    return (
        f"Step {step}/{num_steps} | Loss: {loss:.4f} | "
        f"Time: {step_time:.3f}s | "
        f"Samples/sec: {batch_size / step_time:.1f}"
    )
