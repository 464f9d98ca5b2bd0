from .checkpoint import (save_checkpoint, restore_checkpoint,  # noqa
                         restore_on_device, restore_resharded,
                         latest_checkpoint, CheckpointManager)
