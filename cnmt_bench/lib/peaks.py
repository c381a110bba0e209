"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
# float32-accurate products on the tensor cores cost three TF32 products
# (3 x TF32): the rate the port's float32 attention kernels run at
FP32_3XTF32_FLOPS = TF32_FLOPS / 3
FP32_SIMT_FLOPS = 67e12
BF16_FLOPS = 989e12
