"""Dense/GQA decoder: layers, attention and the stacked-layer transformer."""
