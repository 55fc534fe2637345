"""One module per traffic kind; ``run(ctx)`` drives a cell once."""
