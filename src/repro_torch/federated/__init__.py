from repro_torch.federated.aggregation import (finite_rows,
                                               make_server_optimizer,
                                               server_update, tree_finite,
                                               weighted_delta,
                                               zero_nonfinite_rows)
from repro_torch.federated.server import (FLConfig, FLHistory,
                                          cap_stragglers, run_fl)
from repro_torch.federated.simulation import (BudgetLedger,
                                              DeviceRoundOutcome,
                                              RoundOutcome, budget_gate,
                                              cohort_energy_j,
                                              predicted_round_cost_pct,
                                              round_cost_table,
                                              simulate_round,
                                              simulate_round_device)

__all__ = ["finite_rows", "make_server_optimizer", "server_update",
           "tree_finite", "weighted_delta", "zero_nonfinite_rows",
           "FLConfig", "FLHistory", "cap_stragglers", "run_fl",
           "BudgetLedger", "DeviceRoundOutcome", "RoundOutcome",
           "budget_gate", "cohort_energy_j", "predicted_round_cost_pct",
           "round_cost_table", "simulate_round", "simulate_round_device"]
