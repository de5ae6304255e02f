"""PyTorch port of ode_rl_tpu for NVIDIA Hopper (H100).

Slice 1: the flagship ODE-ConvGRU training step (on-device Moving MNIST,
conv encoder, backward ODE-ConvGRU z0 encoder, adaptive dopri5 decode with
the O(NFE) adjoint, conv decoder, MSE, Adam). Slice 2: FlowNet training
(flow/): FlowNetC and the stacked FlowNet2 on the synthetic-chairs stream.
Slice 8: the training recipe's own path, ``python -m ode_rl_torch.main
--configs defaults train_mmnist_odecgru_len20_1ch`` (configs.yaml read by
core/config.py, the 'scan' solver, the frozen corpus, eval metrics,
checkpoints and the train/test loop). Slices 10-12: the recurrent,
S3VAE and Vid-ODE families through the same entry point.
Module paths and names follow ``ode_rl_tpu``; public functions take and
return NHWC. The kernels K1-K8 (ops/) are hand-written CUDA for sm_90a; on
CPU tensors each runs its plain PyTorch version. This package never
imports JAX.
"""
