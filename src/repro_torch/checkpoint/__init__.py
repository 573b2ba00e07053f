from repro_torch.checkpoint.store import (  # noqa: F401
    latest_checkpoint, load_tree, save_checkpoint, save_tree)
