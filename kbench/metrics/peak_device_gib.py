"""torch.cuda.max_memory_allocated() over set-up and window, in GiB."""


def read(run):
    if run.device != "cuda":
        return None
    return run.torch.cuda.max_memory_allocated() / 2**30
