"""card_idle_share.dp4: percent, the mean card's idle share over the traced window:
100 x (1 - the seconds of every device operation on all the cards / (CARDS x the window)),
each operation clipped to the window.  Operations that overlap on one card's two streams (a
batch's program and the fetch behind the batch before it) count twice, so where they overlap
the share reads lower than the card's idle time.  Nothing without a trace that saw the cards."""

CARDS = 4  # the cell's dp mesh


def read(reading):
    tr = reading.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    lo, hi = tr.window
    busy = sum(max(0.0, min(b, hi) - max(a, lo)) for _, a, b in tr.device)
    return 100.0 * (1.0 - busy / (CARDS * tr.window_s))
