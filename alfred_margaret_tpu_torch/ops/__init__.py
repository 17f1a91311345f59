"""Stream layout, the dense and bitap count engines and their dispatcher."""
