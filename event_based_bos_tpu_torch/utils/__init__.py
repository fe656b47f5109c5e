"""Host-side utilities: config/CLI, logging, the error-text reader, the
section timer and the resumable results store."""

from .config import parse_args, propagate_config, save_config  # noqa: F401
from .misc import (check_key_and_bool, fix_random_seed,  # noqa: F401
                   read_flow_error_text)
