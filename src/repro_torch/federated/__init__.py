from repro_torch.federated.aggregation import (finite_rows,
                                               make_server_optimizer,
                                               server_update, tree_finite,
                                               weighted_delta,
                                               zero_nonfinite_rows)
from repro_torch.federated.faults import (FaultConfig, FaultDraw,
                                          apply_faults, fault_streams,
                                          faults_for_round)
from repro_torch.federated.server import (FLConfig, FLHistory,
                                          cap_stragglers, run_fl,
                                          run_fl_scanned,
                                          run_selection_scanned)
from repro_torch.federated.simulation import (BudgetLedger,
                                              DeviceRoundOutcome,
                                              RoundOutcome, budget_gate,
                                              cohort_energy_j,
                                              make_round_engine,
                                              predicted_round_cost_pct,
                                              round_cost_table,
                                              run_rounds_scanned,
                                              simulate_round,
                                              simulate_round_device)

__all__ = ["finite_rows", "make_server_optimizer", "server_update",
           "tree_finite", "weighted_delta", "zero_nonfinite_rows",
           "FaultConfig", "FaultDraw", "apply_faults", "fault_streams",
           "faults_for_round",
           "FLConfig", "FLHistory", "cap_stragglers", "run_fl",
           "run_fl_scanned", "run_selection_scanned",
           "BudgetLedger", "DeviceRoundOutcome", "RoundOutcome",
           "budget_gate", "cohort_energy_j", "make_round_engine",
           "predicted_round_cost_pct", "round_cost_table",
           "run_rounds_scanned", "simulate_round", "simulate_round_device"]
