"""Device and toolchain helpers of the PyTorch port."""
