"""Device milliseconds a chunk of the kernels the program's call launches
(the profiler's device time of each activity launched inside the chunk's
range), over the window's chunks."""


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    seconds = sum(k["seconds"] for k in trace["kernels"]
                  if k["owner"] == "portbench.chunk")
    return seconds * 1e3 / trace["chunks"] if seconds > 0 else None
