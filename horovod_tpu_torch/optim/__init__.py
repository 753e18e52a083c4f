"""Block int8 quantization math."""
