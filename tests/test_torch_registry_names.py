"""The port's op registry against mxtpu's, name by name.

Every name (aliases included) both registries hold has mxtpu's input
count and its parameters: their names, types and defaults, in order
(a required parameter on both sides).  The names mxtpu has and the
port lacks are listed below as one explicit set: porting an op takes
its names out of the set, and the test fails on a name that is in
neither the port's registry nor the set, or in both.
"""
import pytest

import mxtpu.ndarray  # noqa: F401  (populates mxtpu's registry)
from mxtpu.ops import registry as jreg

import mxtpu_torch.ndarray  # noqa: F401  (populates the port's)
from mxtpu_torch.ops import registry as treg

# mxtpu's op names the port has not ported yet (ROADMAP queue 1)
NOT_PORTED = {
    "AdaptiveAvgPooling2D", "BilinearResize2D", "BilinearSampler", "CTCLoss",
    "Correlation", "Crop", "DeformableConvolution", "DeformablePSROIPooling",
    "ElementWiseSum", "GridGenerator", "GroupNorm",
    "IdentityAttachKLSparseReg", "L2Normalization", "LRN",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MakeLoss", "PSROIPooling",
    "SVMOutput", "SliceChannel", "SoftmaxActivation", "SpatialTransformer", "SwapAxis",
    "SyncBatchNorm", "UpSampling", "_arctan2",
    "_contrib_AdaptiveAvgPooling2D", "_contrib_BilinearResize2D",
    "_contrib_CountSketch", "_contrib_DeformableConvolution",
    "_contrib_DeformablePSROIPooling",
    "_contrib_PSROIPooling", "_contrib_SyncBatchNorm",
    "_contrib_boolean_mask", "_contrib_count_sketch", "_contrib_fft",
    "_contrib_getnnz", "_contrib_ifft", "_contrib_index_copy",
    "_contrib_quadratic", "_contrib_quantize_v2", "_contrib_quantized_act",
    "_contrib_quantized_concat", "_contrib_quantized_conv",
    "_contrib_quantized_flatten", "_contrib_quantized_fully_connected",
    "_contrib_quantized_pooling", "_contrib_requantize", "_crop_assign",
    "_crop_assign_scalar", "_empty", "_eye", "_full", "_histogram", "_hypot",
    "_hypot_scalar", "_image_flip_left_right", "_image_flip_top_bottom",
    "_image_normalize", "_image_random_flip_left_right",
    "_image_random_flip_top_bottom", "_image_to_tensor", "_linspace",
    "_logical_and", "_logical_and_scalar", "_logical_or",
    "_logical_or_scalar", "_logical_xor", "_logical_xor_scalar", "_ones",
    "_random_exponential", "_random_gamma",
    "_random_generalized_negative_binomial", "_random_negative_binomial",
    "_random_normal", "_random_poisson", "_random_randint", "_random_uniform",
    "_ravel_multi_index", "_sample_exponential", "_sample_gamma",
    "_sample_generalized_negative_binomial", "_sample_multinomial",
    "_sample_negative_binomial", "_sample_normal", "_sample_poisson",
    "_sample_uniform", "_sample_unique_zipfian", "_scatter_elemwise_div",
    "_scatter_minus_scalar", "_scatter_plus_scalar", "_scatter_set_nd",
    "_shuffle", "_slice_assign", "_slice_assign_scalar",
    "_sparse_adagrad_update", "_split_v2", "_unravel_index", "_zeros",
    "adadelta_update", "adagrad_update", "add_n", "all_finite", "amp_cast",
    "amp_multicast", "arccos", "arccosh", "arcsin", "arcsinh", "arctan",
    "arctan2", "arctanh", "argmax_channel", "argsort", "batch_dot",
    "batch_take", "broadcast_axis", "broadcast_hypot", "broadcast_like",
    "broadcast_logical_and", "broadcast_logical_or", "broadcast_logical_xor",
    "broadcast_to", "cast_storage", "cbrt", "col2im", "cos", "cosh",
    "ctc_loss", "degrees", "depth_to_space", "dequantize", "diag", "digamma",
    "dot", "erf", "erfinv", "expm1", "fill_element_0index", "fix", "flip",
    "gamma", "gammaln", "gather_nd", "hard_sigmoid", "histogram", "im2col",
    "image_flip_left_right", "image_flip_top_bottom", "image_normalize",
    "image_random_flip_left_right", "image_random_flip_top_bottom",
    "image_to_tensor", "khatri_rao", "linalg_det", "linalg_extractdiag",
    "linalg_extracttrian", "linalg_gelqf", "linalg_gemm", "linalg_gemm2",
    "linalg_inverse", "linalg_makediag", "linalg_maketrian", "linalg_potrf",
    "linalg_potri", "linalg_slogdet", "linalg_sumlogdiag", "linalg_syevd",
    "linalg_syrk", "linalg_trmm", "linalg_trsm", "log10", "log1p", "log2",
    "log_sigmoid", "logical_not", "logical_xor", "make_loss", "matmul",
    "mish", "moments", "mp_nag_mom_update", "mp_sgd_mom_update",
    "mp_sgd_update", "multi_all_finite", "multi_mp_sgd_mom_update",
    "multi_mp_sgd_update", "nag_mom_update", "nanprod", "nansum", "norm",
    "one_hot", "prod", "quantize", "quantize_v2", "quantized_act",
    "quantized_concat", "quantized_conv", "quantized_flatten",
    "quantized_fully_connected", "quantized_pooling", "radians",
    "ravel_multi_index", "rcbrt", "repeat", "requantize", "reverse", "rint",
    "round", "scatter_nd", "shape_array", "shuffle", "sin", "sinh",
    "size_array", "slice", "softmax_activation", "softmax_cross_entropy",
    "softmin", "softsign", "sort", "space_to_depth", "sparse_retain", "split",
    "split_v2", "sum_axis", "swapaxes", "tan", "tile", "topk", "trunc",
    "unravel_index",
}

J_NAMES = set(jreg.OP_REGISTRY._entries)
T_NAMES = set(treg.OP_REGISTRY._entries)


def _spec(reg, name):
    op = reg.OP_REGISTRY._entries[name]
    return {"num_inputs": op.num_inputs,
            "params": [(p.name, p.dtype,
                        "required" if p.required else p.default)
                       for p in op.params.params.values()]}


def test_every_mxtpu_name_is_ported_or_listed():
    assert len(J_NAMES) == 408
    assert not T_NAMES - J_NAMES, "names mxtpu does not have"
    assert not NOT_PORTED & T_NAMES, "ported: take them out of the set"
    assert not NOT_PORTED - J_NAMES, "not an mxtpu name"
    assert J_NAMES - T_NAMES == NOT_PORTED
    assert len(NOT_PORTED) == 233


@pytest.mark.parametrize("name", sorted(J_NAMES & T_NAMES))
def test_shared_name_matches_mxtpu(name):
    assert _spec(treg, name) == _spec(jreg, name)
