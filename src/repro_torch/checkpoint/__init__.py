from repro_torch.checkpoint.ckpt import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, Checkpointer)
