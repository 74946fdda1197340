"""Command-line interface and servers of the PyTorch port (counterpart of
neuralcodecs_tpu.cli; the `neuralcodecs-torch` console script)."""
