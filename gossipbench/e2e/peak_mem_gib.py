"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the
window, reset at its start, in GiB: what the nodes a card holds rest on."""


def value(window):
    return window.peak_bytes / 2**30 if window.peak_bytes else None
