from .formats import (
    BLOCK,
    FIELDS,
    FOLD,
    FOUR_BIT,
    QUANT_FORMATS,
    SUB16,
    SUPER,
    QuantTensor,
    concat_n,
    dequantize,
    quantize,
    quantize_q4_0,
    quantize_q4_k,
    quantize_q6_k,
    quantize_q8_0,
    stack_layers,
    supported_format_for,
)

__all__ = [
    "BLOCK", "FIELDS", "FOLD", "FOUR_BIT", "QUANT_FORMATS", "SUB16", "SUPER",
    "QuantTensor", "concat_n", "dequantize", "quantize", "quantize_q4_0",
    "quantize_q4_k", "quantize_q6_k", "quantize_q8_0", "stack_layers",
    "supported_format_for",
]
