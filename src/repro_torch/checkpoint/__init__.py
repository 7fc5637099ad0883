from .ckpt import (AsyncCheckpointer, latest_step, restore_checkpoint,  # noqa: F401
                   save_checkpoint)
