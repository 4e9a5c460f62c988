"""Quantization: fake-quant, range estimation, the PTQ calibration, int8
weights for the W8A8 tick and the int8 paged-KV codec (port of
``repro.quant``)."""
from repro_torch.quant.int8_weights import (
    attach_int8_weights,
    build_int8_cache,
    int8_cache_bytes,
    linear_int8,
)
from repro_torch.quant.kv_cache import kv_dequant, kv_quant
from repro_torch.quant.ptq import (
    calibrate,
    evaluate_perplexity,
    make_quantized_apply,
    ptq_sweep,
)
from repro_torch.quant.qconfig import NO_QUANT, QConfig, QuantContext
from repro_torch.quant.quantizer import (
    QuantSpec,
    dequantize,
    fake_quant,
    quantization_error,
    quantize,
    scale_zero_point,
)
from repro_torch.quant.ranges import (
    MinMaxEstimator,
    MSEEstimator,
    PercentileEstimator,
    RangeEstimator,
    RunningMinMaxEstimator,
    make_estimator,
)

__all__ = [
    "QuantSpec", "dequantize", "fake_quant", "quantization_error", "quantize",
    "scale_zero_point",
    "MinMaxEstimator", "MSEEstimator", "PercentileEstimator", "RangeEstimator",
    "RunningMinMaxEstimator", "make_estimator",
    "NO_QUANT", "QConfig", "QuantContext", "calibrate", "evaluate_perplexity",
    "make_quantized_apply", "ptq_sweep",
    "attach_int8_weights", "build_int8_cache", "int8_cache_bytes",
    "linear_int8", "kv_quant", "kv_dequant",
]
