"""One driver per traffic kind: ``run(ctx) -> record``."""
