"""PyTorch/CUDA port of the streaming system: the IRM, the live runtime and
the scenarios, with a per-message payload that runs a hand-written Hopper
grouped-matmul kernel (``runtime.payloads.TorchPayload``)."""
