"""Generation (serving) loops."""
