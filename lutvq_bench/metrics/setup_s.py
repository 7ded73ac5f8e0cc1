"""Process start to the window's opening: imports, the model, the kernels
built or loaded, the batcher, and the ramp of the clients."""


def read(rec):
    return rec.window_open - rec.t_start
