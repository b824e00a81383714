from .dpfl import (DPFLConfig, DPFLResult, graph_stats, run_dpfl,
                   run_dpfl_reference)

__all__ = ["DPFLConfig", "DPFLResult", "graph_stats", "run_dpfl",
           "run_dpfl_reference"]
