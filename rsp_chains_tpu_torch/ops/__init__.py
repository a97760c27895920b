"""Plain PyTorch ops of the FFT -> magnitude -> CFAR chain."""
