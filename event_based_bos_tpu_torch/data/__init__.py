"""Data sources of the port: the synthetic BOS generator and the dataset
loaders, with the registry the CLI reads (``data.dataset`` in the YAML):
``SYNTHETIC``, the ``CCS`` recordings (HDF5 or raw EVT3 events, mp4
frames), ``E2VID`` reconstructions (PNGs) and ``HELIUM`` frame sequences
(TIFs, no events).
"""

from . import synthetic  # noqa: F401
from .base import DATASET_ROOT_DIR, DataLoaderBase  # noqa: F401
from .ccs import CcsDataLoader
from .e2vid import E2vidDataLoader
from .helium import HeliumDataLoader
from .synthetic import SyntheticBosConfig, generate_sequence  # noqa: F401
from .synthetic_loader import SyntheticDataLoader

collections = {
    cls.NAME: cls
    for cls in (CcsDataLoader, E2vidDataLoader, HeliumDataLoader,
                SyntheticDataLoader)
}
