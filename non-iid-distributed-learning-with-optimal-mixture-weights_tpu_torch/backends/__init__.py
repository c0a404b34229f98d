"""Execution backends behind ``registry.get_backend``: ``torch_ref``, the
plain PyTorch reference (``get_backend("torch")``)."""
