from .checkpoint import (save_checkpoint, restore_checkpoint,  # noqa
                         restore_on_device, latest_checkpoint,
                         CheckpointManager)
