"""Device milliseconds a round of the operations launched inside
the GGC refresh (core.dpfl's all_clients_graph or all_clients_graph_sparse, the reward forwards within), from the traced window."""


def read(run):
    tr = run.trace
    if tr is None or not run.rounds or "greedy" not in tr.layer_s:
        return None
    return 1e3 * tr.layer_s["greedy"] / run.rounds
