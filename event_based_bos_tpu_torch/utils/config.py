"""Config / CLI layer: YAML configs with the reference's propagation.

PyTorch port's copy of the JAX package's ``utils/config.py``: the same CLI
flags (``--config_file``, ``--log``, ``--eval``), the same YAML schema
(``configs/README.md``) and the same cross-section propagation of the common
ROI.  ``yaml`` is imported only where a file is parsed, so the package
imports on a machine without PyYAML.  :class:`PivSettings` is the plain
settings record of the port's PIV (:mod:`event_based_bos_tpu_torch.piv`),
built from the YAML's ``params_openpiv`` by :func:`load_config_openpiv`.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import shutil
import sys
from typing import Optional, Tuple

__all__ = ["parse_args", "propagate_config", "save_config", "PivSettings",
           "load_config_openpiv"]


def parse_args(default_path: str = "./configs/synthetic_plume.yaml",
               argv=None):
    """Parse the CLI flags and load + propagate the YAML config; returns
    ``(config, args)``."""
    import yaml

    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", default=default_path,
                        help="Config file yaml path", type=str)
    parser.add_argument("--log", type=str, default="info",
                        help="Log level: [debug, info, warning, error, "
                             "critical]")
    parser.add_argument("--eval", action="store_true",
                        help="Enable for evaluation run")
    args = parser.parse_args(argv)
    with open(args.config_file) as f:
        config = yaml.safe_load(f)
    propagate_config(config)
    return config, args


def propagate_config(config: dict) -> None:
    """In-place propagation of common parameters across config sections:
    the ROI copied into the data and solver-filter sections, the crop and
    pad geometry derived, the evaluation ``dt`` set to ``n_frames``, and the
    pad geometry added to every frame-flow parameter section."""
    for key in ("xmin", "xmax", "ymin", "ymax"):
        config["data"][key] = config["common_params"][key]
        if "solver" in config:
            config["solver"]["filter"]["parameters"][key] = \
                config["common_params"][key]

    config["data"]["crop_height"] = (config["data"]["xmax"]
                                     - config["data"]["xmin"])
    config["data"]["crop_width"] = (config["data"]["ymax"]
                                    - config["data"]["ymin"])

    pad_config = {
        "pad_x0": config["common_params"]["xmin"],
        "pad_x1": config["data"]["height"] - config["common_params"]["xmax"],
        "pad_y0": config["common_params"]["ymin"],
        "pad_y1": config["data"]["width"] - config["common_params"]["ymax"],
    }

    if "solver" in config:
        config["solver"]["params_opencv_flow"] = config.get(
            "params_opencv_flow", {})
        config["solver"]["params_openpiv"] = config.get("params_openpiv", {})
        config["solver"].update(pad_config)
        config["solver"]["crop_height"] = config["data"]["crop_height"]
        config["solver"]["crop_width"] = config["data"]["crop_width"]

    if "evaluation" in config:
        config["evaluation"]["dt"] = config["common_params"]["n_frames"]

    for k in ("opencv_flow", "openpiv", "rife", "flowformer"):
        section = f"params_{k}"
        if section in config:
            config[section].update(pad_config)
        else:
            config[section] = dict(pad_config)


def save_config(save_dir: str, file_name: str,
                log_level: str = "INFO") -> None:
    """Copy the config into the output directory and configure logging to
    ``main.log`` there and to stdout (replacing the root handlers)."""
    os.makedirs(save_dir, exist_ok=True)
    shutil.copy(file_name, save_dir)
    level = getattr(logging, log_level.upper(), None)
    if not isinstance(level, int):
        raise ValueError(f"Invalid log level: {log_level}")
    logging.basicConfig(
        handlers=[
            logging.FileHandler(os.path.join(save_dir, "main.log"), mode="w"),
            logging.StreamHandler(sys.stdout),
        ],
        level=level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        force=True,
    )


@dataclasses.dataclass
class PivSettings:
    """Settings of the multipass window-deformation PIV
    (:mod:`event_based_bos_tpu_torch.piv`): the options of OpenPIV's
    ``windef.Settings`` that the pipeline reads, with OpenPIV's defaults."""

    roi: Optional[Tuple[int, int, int, int]] = None  # xmin, xmax, ymin, ymax
    windowsizes: Tuple[int, ...] = (64, 32, 16, 8)
    overlap: Tuple[int, ...] = (32, 16, 8, 4)
    deformation_method: str = "symmetric"  # or "second image"
    subpixel_method: str = "gaussian"
    correlation_method: str = "circular"
    sig2noise_threshold: float = 1.0
    sig2noise_method: str = "peak2peak"
    sig2noise_mask: int = 2
    sig2noise_validate: bool = False
    validation_first_pass: bool = True
    replace_vectors: bool = True
    filter_method: str = "localmean"
    max_filter_iteration: int = 2
    filter_kernel_size: int = 1
    min_max_u_disp: Tuple[float, float] = (-20, 20)
    min_max_v_disp: Tuple[float, float] = (-20, 20)
    std_threshold: float = 5.0
    median_threshold: float = 5.0
    median_size: int = 2
    smoothn: bool = True
    smoothn_p: float = 0.05
    scaling_factor: float = 1.0
    dt: float = 1.0

    @property
    def num_iterations(self) -> int:
        return len(self.windowsizes)


def load_config_openpiv(params_openpiv: dict, common_config: dict,
                        save_dir: str) -> PivSettings:
    """PIV settings from the YAML's ``params_openpiv`` section: the window
    sizes and overlaps, the deformation method and the displacement
    limits; the ROI from ``common_config`` unless ``ROI: full``.
    ``save_dir`` is accepted for the reference's signature."""
    if params_openpiv.get("ROI") == "full":
        roi = None
    else:
        roi = (common_config["xmin"], common_config["xmax"],
               common_config["ymin"], common_config["ymax"])
    return PivSettings(
        roi=roi,
        windowsizes=tuple(params_openpiv["windowsizes"]),
        overlap=tuple(params_openpiv["overlap"]),
        deformation_method=params_openpiv.get("deformation_method",
                                              "symmetric"),
        min_max_u_disp=tuple(params_openpiv.get("MinMax_U_disp", (-20, 20))),
        min_max_v_disp=tuple(params_openpiv.get("MinMax_V_disp", (-20, 20))),
    )
