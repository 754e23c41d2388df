"""The round trip: each step codes one GOP of the clip from its frames and
decodes it back (``Program.roundtrip``); set-up makes nothing more."""

CONTAINERS = False  # the window's input is frames, not containers


def build(prog, gops):
    """(the window's step, None). Step ``i`` works on the clip's GOP
    ``i % len(gops)`` and returns (its outputs, a device ok flag, info)."""
    n = len(gops)
    return (lambda i: prog.roundtrip(gops[i % n])), None
