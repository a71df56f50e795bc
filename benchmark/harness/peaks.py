"""The card's peaks that roofline shares divide by: NVIDIA's data sheet
for the H100 SXM (80 GB HBM3), dense rates, at its full 700 W power limit.
A card set below that limit runs slower under load; every number the
benchmark keeps is written beside the card's name and limit."""

HBM_BYTES_PER_S = 3.35e12
# 67 TFLOP/s of float32 outside the tensor cores counts a fused
# multiply-add as two operations; an add, a subtract or a compare is one
# instruction of the same rate, so other float32 operations peak at half
OPS_PER_S = 33.5e12
