"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that a step or a request needs, counted from the cell's shapes and
from the reference's walk of the cell's inputs (never from the program's
tables or counters).

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s FP32
outside the tensor cores (the program pins full FP32: no TF32), 3.35 TB/s
of HBM3. The special-function unit issues exp at 1/16 of the FP32 rate,
so an exp counts 16 operations.
"""
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SFU = 16

# one (pixel, entry) pair the pixel needs, in the forward: the offset and
# the power (2 subtractions, 3 multiplies and 3 FMAs at 2: 12), the exp,
# the alpha's product, cap and 1/255 test (3), the T update and its test
# (1), the weight (1) and 3 FMAs per colour pass (6)
PAIR_FWD = 12 + SFU + 3 + 1 + 1
PAIR_FWD_PER_PASS = 6
# the backward repeats the forward's work on the pair, then the gradient
# chain: the weight, dalpha and its divide, dpower, the mean's two terms,
# the three conic terms, the opacity's, the abs channel and the T update
# (40) and one add per gradient row into the entry's sum (7); per pass the
# colour gradient, the prefix, the suffix and its add (13 + 3)
PAIR_BWD = PAIR_FWD + 40 + 7
PAIR_BWD_PER_PASS = PAIR_FWD_PER_PASS + 13 + 3


def entry_floats(passes: int) -> int:
    """An entry's attributes: mean (2), conic (3), opacity, 3 colours a pass."""
    return 6 + 3 * passes


def grad_rows(passes: int) -> int:
    """An entry's gradient: its attributes' and the abs-gradient channel."""
    return entry_floats(passes) + 1


def blend_fwd(w: dict, passes: int):
    """(operations, bytes) of the forward blend: the needed entries read
    once, each pixel's colours and final T written once."""
    ops = w["pairs"] * (PAIR_FWD + PAIR_FWD_PER_PASS * passes)
    nbytes = 4 * (w["entries"] * entry_floats(passes) + w["pixels"] * (3 * passes + 1))
    return ops, nbytes


def blend_bwd(w: dict, passes: int):
    """(operations, bytes) of the backward blend: the needed entries and,
    per pixel, the colour cotangents, the forward's colours and final T and
    its cotangent read once; each needed entry's gradient row written once."""
    ops = w["pairs"] * (PAIR_BWD + PAIR_BWD_PER_PASS * passes)
    nbytes = 4 * (w["entries"] * (entry_floats(passes) + grad_rows(passes))
                  + w["pixels"] * (6 * passes + 2))
    return ops, nbytes


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


# dense work per live Gaussian, forward: the activations and the 3D filter
# (~30), the covariance (~40), the projection and the EWA covariance with
# its dilation, conic and radius (~110), the degree-3 SH of 16 terms in 3
# channels (basis ~30, 96 FMAs at 2: ~220 with the clamps) per pass
PREPROCESS = 180
SH_PER_PASS = 220
# the appearance MLP (3 + 24 + 32 -> 128 -> 128 -> 6), two FLOPs a
# multiply-add, plus the affine map of the 48 SH coefficients (~100)
MLP = 2 * (59 * 128 + 128 * 128 + 128 * 6) + 100
# the loss per canvas pixel: SSIM's five 11-tap separable filters on 3
# channels (5 * 3 * 2 * 11 * 2 = 660) and its ~30 elementwise terms, the
# L1 and the weights (~10)
LOSS = 700
# the DINOv2 ViT-S/14 forward at 336: 581 tokens, width 384, 6 blocks
# (qkv, scores, values, projection, MLP of 1536: 2 FLOPs a multiply-add),
# the patch embedding; the uncertainty head and its resizes are small
VIT_TOKENS, VIT_DIM, VIT_BLOCKS = 581, 384, 6
VIT = VIT_BLOCKS * (2 * VIT_TOKENS * VIT_DIM * 3 * VIT_DIM + 4 * VIT_TOKENS ** 2 * VIT_DIM
                    + 2 * VIT_TOKENS * VIT_DIM ** 2 + 4 * VIT_TOKENS * VIT_DIM * 4 * VIT_DIM) \
    + 2 * 576 * 14 * 14 * 3 * VIT_DIM
# a backward costs twice its forward
BWD = 2


def step_ops(w: dict, appearance: bool, uncertainty: bool) -> float:
    """A training step's operations: the blend both ways, and forward and
    backward of the dense work the shapes fix (the ViT forward once: the
    true image's features are cached)."""
    passes = w["passes"]
    dense = w["gaussians"] * (PREPROCESS + SH_PER_PASS * passes + (MLP if appearance else 0))
    dense += w["pixels"] * LOSS
    return (blend_fwd(w, passes)[0] + blend_bwd(w, passes)[0] + dense * (1 + BWD)
            + (VIT if uncertainty else 0))


def request_ops(w: dict, appearance: bool) -> float:
    """A request's operations: the one image it returns (one pass) and the
    dense work in front of it."""
    dense = w["gaussians"] * (PREPROCESS + SH_PER_PASS * (2 if appearance else 1)
                              + (MLP if appearance else 0))
    return blend_fwd(w, 1)[0] + dense
