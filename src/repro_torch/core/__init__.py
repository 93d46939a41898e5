"""QADAM core in torch (port of ``repro.core``, the quickstart slice).

  arch      — accelerator design space (PE array, buffers, PE types)
  pe        — per-PE-type energy/area/delay tables
  energy    — memory-hierarchy energy constants
  synth     — synthesis oracle (stand-in for Synopsys DC + FreePDK45)
  workloads — layer-wise CNN workloads (VGG-16, ResNet-CIFAR)
  dataflow  — row-stationary analytical cost model (broadcast tensors)
  ppa       — polynomial-regression PPA surrogates + k-fold CV selection
  costmodel — oracle/surrogate cost-model backends + registry
  dse       — design-space evaluation, Pareto fronts, the paper's reports
"""

from repro_torch.core.arch import (AcceleratorConfig, DEFAULT_SPACE,
                                   MAPPED_SPACE, MAPPING_CHOICES,
                                   PE_TYPE_CODES, PE_TYPE_NAMES, WIDE_SPACE,
                                   config_rows, enumerate_space,
                                   iter_space_chunks, make_config,
                                   space_points, space_radices, space_size,
                                   stack_configs, subsample_indices)
from repro_torch.core.costmodel import (CostModel, OracleCostModel,
                                        SurrogateCostModel, as_cost_model,
                                        cost_model, register_cost_model)
from repro_torch.core.dataflow import (LayerCost, layer_cost, network_cost,
                                       reduce_layer_costs)
from repro_torch.core.dse import (DEFAULT_CHUNK_SIZE, DseResult, best_index,
                                  dispatch_chunk, evaluate_chunk,
                                  evaluate_space, finish_chunk,
                                  normalized_report, pareto_front,
                                  pareto_mask, pareto_mask_2d,
                                  pareto_mask_dense, pareto_mask_tiled,
                                  report_pe_types, spread)
from repro_torch.core.ppa import (PPAModels, PolyModel, fit_ppa_models, mape,
                                  r2, select_and_fit, surrogate_ppa)
from repro_torch.core.synth import (LEAKAGE_MW_PER_MM2, SynthResult,
                                    oracle_ppa, synthesize)
from repro_torch.core.workloads import (LayerSpec, Workload, resnet_cifar,
                                        vgg16, weight_shapes, workload_macs)
