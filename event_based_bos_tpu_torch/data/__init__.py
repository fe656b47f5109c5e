"""Data sources of the port: the synthetic BOS generator and the dataset
loaders, with the registry the CLI reads (``data.dataset`` in the YAML).

The ``SYNTHETIC`` loader and the ``CCS`` recording loader (HDF5 or raw
EVT3 events, mp4 frames) are ported; ``E2VID`` and ``HELIUM`` are
registered and raise ``NotImplementedError`` until ROADMAP Queue 1 #14b
ports them.
"""

from . import synthetic  # noqa: F401
from .base import DATASET_ROOT_DIR, DataLoaderBase  # noqa: F401
from .ccs import CcsDataLoader
from .synthetic import SyntheticBosConfig, generate_sequence  # noqa: F401
from .synthetic_loader import SyntheticDataLoader


def _not_ported(name: str):
    class _NotPorted(DataLoaderBase):
        NAME = name

        def __init__(self, config=None):
            raise NotImplementedError(
                f"the {name} data loader is not ported yet (ROADMAP Queue 1 "
                f"#14b); the port has the SYNTHETIC and CCS loaders")

    _NotPorted.__name__ = _NotPorted.__qualname__ = f"{name.title()}DataLoader"
    return _NotPorted


collections = {
    cls.NAME: cls
    for cls in (CcsDataLoader, _not_ported("E2VID"), _not_ported("HELIUM"),
                SyntheticDataLoader)
}
