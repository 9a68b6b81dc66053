"""device_idle_share: the share of the traced span's wall time in which no
kernel, copy or fill ran on the card (torch.profiler), in percent.  Moves
tokens_per_s."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
