"""setup_s: seconds from the harness's start (imports, the kernels'
build on a checkout's first run, the inputs made from the seed, what the
calls need, one warm call) to the window."""


def read(t):
    return t["setup_s"]
