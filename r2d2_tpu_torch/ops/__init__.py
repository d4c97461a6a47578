"""Pure functional math and the LSTM kernels (ops/lstm_kernel.py)."""
