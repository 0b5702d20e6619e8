"""MiB a ``conv2d`` call allocates beyond what was live before it and the
tensors it returns (its output; training, also the two gradients), the
largest over the stack's layer shapes: the paper's memory overhead as the
card's allocator sees it."""


def read(trace):
    ws = trace.get("workspace_bytes")
    if not ws:
        return None
    return max(0, max(ws.values())) / 2 ** 20
