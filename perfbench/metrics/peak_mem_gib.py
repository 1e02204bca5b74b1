"""Device: the most memory allocated on the card during the window
(``torch.cuda.max_memory_allocated`` after a reset when it opened), in
GiB."""


def read(run):
    if not run.served.peak_bytes:
        return None
    return run.served.peak_bytes / 2**30
