"""Process start to the first timed step or request: loading, drawing
the weights, building and warming (host clock)."""


def read(obs):
    return obs.setup_s
