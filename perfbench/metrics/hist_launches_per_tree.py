"""``hist_launches_per_tree``: launches of the port's histogram kernels
(the wrappers' counters: kernels 1, 2, 3 and the deterministic mode) over
the trees the window's fits grew."""


def read(run):
    c, trees = run.layer.get("counts"), run.layer.get("trees")
    if not c or not trees:
        return None
    return (c["kernel1"] + c["kernel2"] + c["det"] + c["cols"]) / trees
