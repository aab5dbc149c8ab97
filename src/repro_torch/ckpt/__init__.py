from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint
