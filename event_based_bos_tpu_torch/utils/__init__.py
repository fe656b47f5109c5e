"""Host-side utilities: config/CLI, logging, the error-text reader, the
cProfile decorator, video files, the section timer and the resumable
results store."""

from .config import (PivSettings, load_config_openpiv,  # noqa: F401
                     parse_args, propagate_config, save_config)
from .misc import (check_key_and_bool, fix_random_seed,  # noqa: F401
                   profile, read_flow_error_text)
from .video import (concat_videos_horizontally, extract_mp4,  # noqa: F401
                    write_video)
