from .io import (flatten_with_keys, latest_checkpoint, restore_checkpoint,
                 save_checkpoint)

__all__ = ["flatten_with_keys", "latest_checkpoint", "restore_checkpoint",
           "save_checkpoint"]
