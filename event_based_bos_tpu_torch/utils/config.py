"""Config / CLI layer: YAML configs with the reference's propagation.

PyTorch port's copy of the JAX package's ``utils/config.py``: the same CLI
flags (``--config_file``, ``--log``, ``--eval``), the same YAML schema
(``configs/README.md``) and the same cross-section propagation of the common
ROI.  ``yaml`` is imported only where a file is parsed, so the package
imports on a machine without PyYAML.  The PIV settings are not ported yet
(ROADMAP Queue 1 #14b).
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys

__all__ = ["parse_args", "propagate_config", "save_config"]


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
