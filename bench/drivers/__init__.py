"""One general driver per traffic ``kind``: ``run(cell) -> Record``."""
