"""The ``prepare_pair`` span of a request (FPS + 3-NN of both clouds,
centring, the sampling sphere): host ms from the call until the card has
finished, the mean of the runner's synchronised calls."""


def read(d):
    return d.get("prepare_ms")
