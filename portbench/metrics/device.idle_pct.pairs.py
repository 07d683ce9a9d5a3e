"""Share of a traced slice's wall time in which no operation ran on the
device, under the pair loop (%): busy time and wall both of the slice
profiled with the device alone, ended by a synchronise."""


def read(trace):
    return 100.0 * trace.idle_share
