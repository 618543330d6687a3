from .formats import BLOCK, QuantTensor, concat_n, dequantize, quantize_q8_0

__all__ = ["BLOCK", "QuantTensor", "concat_n", "dequantize", "quantize_q8_0"]
