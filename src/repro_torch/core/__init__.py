"""QADAM core in torch (port of ``repro.core``).

  arch        — accelerator design space (PE array, buffers, PE types),
                the joint (model x accelerator) space
  pe          — per-PE-type energy/area/delay tables, accuracy deltas
  energy      — memory-hierarchy energy constants
  synth       — synthesis oracle (stand-in for Synopsys DC + FreePDK45)
  workloads   — layer-wise workloads: the paper's CNNs, transformer and
                LLM serving GEMMs, padding and (M, L) stacking
  dataflow    — row-stationary analytical cost model (broadcast tensors)
  ppa         — polynomial-regression PPA surrogates + k-fold CV selection
  costmodel   — oracle/surrogate cost-model backends + registry
  constraints — deployment budgets, feasibility masks, kill counts
  dse         — design-space evaluation (mixed-model lanes, streaming,
                two-stage pruning), Pareto fronts and archive, reports
  accuracy    — per-(model, PE type) accuracy surrogate
  coexplore   — the joint co-exploration front and the LightPE claim
"""

from repro_torch.core.accuracy import (ACC_CLASS_SENS, AccuracySurrogate,
                                       capacity_scale, seeded_base_accuracy)
from repro_torch.core.arch import (AcceleratorConfig, DEFAULT_SPACE,
                                   MAPPED_SPACE, MAPPING_CHOICES,
                                   PE_TYPE_CODES, PE_TYPE_NAMES, WIDE_SPACE,
                                   concat_configs, config_rows,
                                   enumerate_space, iter_joint_space_chunks,
                                   iter_space_chunks, joint_space_points,
                                   joint_space_size, make_config,
                                   space_points, space_radices, space_size,
                                   stack_configs, subsample_indices,
                                   take_config)
from repro_torch.core.coexplore import (COEXPLORE_METRICS, CoexploreFront,
                                        JointDesignPoint, JointWalk,
                                        ModelEntry, accuracy_matrix,
                                        coexplore_front, coexplore_report,
                                        default_model_set, lightpe_claim,
                                        model_entry, plan_joint_walk)
from repro_torch.core.constraints import (Budget, BudgetColumns, BudgetStats,
                                          Constraint, apply_budget,
                                          mask_result)
from repro_torch.core.costmodel import (CostModel, OracleCostModel,
                                        SurrogateCostModel, as_cost_model,
                                        cost_model, register_cost_model)
from repro_torch.core.dataflow import (LayerCost, layer_cost, network_cost,
                                       reduce_layer_costs)
from repro_torch.core.dse import (DEFAULT_CHUNK_SIZE, RESULT_DTYPES,
                                  DseResult, ParetoArchive, TwoStagePruner,
                                  best_index, chunk_dominators,
                                  dispatch_chunk, evaluate_chunk,
                                  evaluate_space, evaluate_space_streaming,
                                  finish_chunk, fold_budget_chunk,
                                  normalized_report, pareto_front,
                                  pareto_front_streaming, pareto_mask,
                                  pareto_mask_2d, pareto_mask_dense,
                                  pareto_mask_tiled, report_pe_types, spread)
from repro_torch.core.ppa import (PPAModels, PolyModel, fit_ppa_models, mape,
                                  r2, select_and_fit, surrogate_ppa)
from repro_torch.core.synth import (LEAKAGE_MW_PER_MM2, SynthResult,
                                    oracle_ppa, synthesize)
from repro_torch.core.workloads import (LayerSpec, MODEL_FAMILIES,
                                        PAPER_WORKLOADS, StackedWorkload,
                                        Workload, acc_class_mix,
                                        layer_bucket, llm_decode, llm_moe,
                                        pad_workload, resnet34, resnet50,
                                        resnet_cifar, stack_workloads,
                                        touched_experts, transformer_gemm,
                                        transformer_workload, vgg16,
                                        weight_shapes, workload_layers,
                                        workload_macs)
