"""Playback: set-up encodes every GOP of the clip to a container with the
program's own encoder; each step decodes one of them, host bytes in,
device frames out (``Program.decode``)."""

CONTAINERS = True  # the window's input is the containers set-up made


def build(prog, gops):
    """(the window's step, the containers). Step ``i`` works on the clip's
    GOP ``i % len(gops)`` and returns (its outputs, a device ok flag,
    info)."""
    blobs = [prog.encode(g) for g in gops]
    n = len(blobs)
    return (lambda i: prog.decode(blobs[i % n])), blobs
