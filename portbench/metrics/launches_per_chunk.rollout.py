"""Launches a chunk: every device activity the profiler sees launched in
the window (the program's fused launches, any other launch of the
program's, the harness's accumulate), over the window's chunks. Read only
where the profiler saw at least the launches the program counted itself
(``FusedRollout.launches``) inside the chunks' ranges."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["unlinked"]:
        return None
    in_chunks = sum(1 for k in trace["kernels"]
                    if k["owner"] == "portbench.chunk")
    if in_chunks < trace["program_launches"]:
        return None
    return trace["launches"] / trace["chunks"]
