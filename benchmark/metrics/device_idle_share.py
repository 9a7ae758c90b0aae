"""device_idle_share (%): share of the traced stretch with no operation
running on the card.

Layer: device (H100). Source: device trace, 1 - busy / window over the
traced stretch (the traced call from its start through its first decode
batches): busy is the union of every device operation's interval, the
window the host clock from the first marker to the synchronized end.
Moves xrt: the card waits for the host in the idle share.
"""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
