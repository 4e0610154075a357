from repro_torch.core.clients import (ClientPopulation, make_population,
                                      round_times, scatter_stat_util)
from repro_torch.core.energy import EnergyModel, pct_to_joules
from repro_torch.core.fairness import jains_index
from repro_torch.core.rewards import (eafl_reward, minmax_normalize,
                                      minmax_range, oort_utility,
                                      projected_power, stat_utility,
                                      system_penalty)
from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                        compute_scores, select,
                                        select_host)

__all__ = ["ClientPopulation", "make_population", "round_times",
           "scatter_stat_util", "EnergyModel", "pct_to_joules",
           "jains_index", "eafl_reward", "minmax_normalize", "minmax_range",
           "oort_utility", "projected_power", "stat_utility",
           "system_penalty", "SelectorConfig", "SelectorState",
           "compute_scores", "select", "select_host"]
