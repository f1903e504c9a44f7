"""Deployment orchestration (paper §3.4): the strategy catalog and its time
model, strategy selection (the decision tree and the DNN's strategy head)
and tick-driven rollout with canary analysis (``repro.core.orchestration``)."""
from repro_torch.core.orchestration.strategies import (
    CATALOG, STRATEGY_NAMES, DeployEnv, Strategy, stage_deploy_seconds,
    total_deploy_seconds,
)
from repro_torch.core.orchestration.selector import (
    DecisionTreeSelector, DeploymentContext, DNNSelector, OutcomeStats,
)
from repro_torch.core.orchestration.rollout import (
    CanaryAnalyzer, CanarySample, HealthPolicy, Phase, RolloutManager,
    binomial_z_pvalue, welch_t_pvalue_one_sided,
)

__all__ = ["CATALOG", "STRATEGY_NAMES", "DeployEnv", "Strategy",
           "stage_deploy_seconds", "total_deploy_seconds",
           "DecisionTreeSelector", "DeploymentContext", "DNNSelector",
           "OutcomeStats", "CanaryAnalyzer", "CanarySample", "HealthPolicy",
           "Phase", "RolloutManager", "binomial_z_pvalue",
           "welch_t_pvalue_one_sided"]
