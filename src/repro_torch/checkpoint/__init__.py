from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CheckpointMeta, latest_step,
                                            restore, save)

__all__ = ["CheckpointManager", "CheckpointMeta", "save", "restore",
           "latest_step"]
