"""Hot ops of the port: the fused rollout (plain PyTorch + CUDA kernel)."""
