from .checkpoint import load_checkpoint, save_checkpoint
from .env import get_config
from .profiling import Timer, timed_loop, trace
