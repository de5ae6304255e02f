"""PyTorch port of ode_rl_tpu for NVIDIA Hopper (H100).

Slice 1: the flagship ODE-ConvGRU training step (on-device Moving MNIST,
conv encoder, backward ODE-ConvGRU z0 encoder, adaptive dopri5 decode with
the O(NFE) adjoint, conv decoder, MSE, Adam). Slice 2: FlowNet training
(flow/): FlowNetC and the stacked FlowNet2 on the synthetic-chairs stream.
Module paths and names follow ``ode_rl_tpu``; public functions take and
return NHWC. The kernels K1-K8 (ops/) are hand-written CUDA for sm_90a; on
CPU tensors each runs its plain PyTorch version. This package never
imports JAX.
"""
