from repro_torch.fed.async_server import AsyncFedServer, simulate_async_rounds
from repro_torch.fed.client import (client_params, evaluate, join_adapters,
                                    loss_and_grads, make_cohort_train,
                                    make_local_train, split_adapters,
                                    split_head)
from repro_torch.fed.compress import (Bf16Codec, Int8Codec, TopKCodec,
                                      WireCodec, codec_from_name)
from repro_torch.fed.messages import (Broadcast, ClientUpdate, EdgeAggregate,
                                      payload_bytes)
from repro_torch.fed.population import (AvailabilityTraceSampler,
                                        ClientPopulation, ClientSampler,
                                        RankStratifiedSampler, UniformSampler,
                                        sampler_from_name)
from repro_torch.fed.schedulers import (BufferedAsync, Scheduler, SemiSync,
                                        SyncRound)
from repro_torch.fed.server import FedServer
from repro_torch.fed.session import (AsyncConfig, FedSession, ServerConfig,
                                     assign_ranks)
from repro_torch.fed.simulation import (SimConfig, make_experiment_setup,
                                        pretrain_backbone, rounds_to_target,
                                        run_centralized, run_experiment,
                                        stack_client_data)
from repro_torch.fed.strategies import (AggregationStrategy, FLoRAStacking,
                                        HLoRA, NaiveAvg, from_name,
                                        register_strategy)
from repro_torch.fed.topology import HierarchicalTopology

__all__ = ["split_adapters", "join_adapters", "split_head", "client_params",
           "loss_and_grads", "make_local_train", "make_cohort_train",
           "evaluate", "SimConfig", "stack_client_data", "Broadcast",
           "ClientUpdate", "EdgeAggregate", "payload_bytes", "Scheduler",
           "SyncRound", "SemiSync", "BufferedAsync", "FedSession",
           "ServerConfig", "AsyncConfig", "assign_ranks",
           "make_experiment_setup",
           "pretrain_backbone", "run_experiment", "run_centralized",
           "rounds_to_target", "AggregationStrategy", "NaiveAvg", "HLoRA",
           "FLoRAStacking", "from_name", "register_strategy",
           # population-scale federation
           "ClientPopulation", "ClientSampler", "UniformSampler",
           "RankStratifiedSampler", "AvailabilityTraceSampler",
           "sampler_from_name", "HierarchicalTopology",
           "WireCodec", "TopKCodec", "Int8Codec", "Bf16Codec",
           "codec_from_name",
           # deprecated shims
           "FedServer", "AsyncFedServer", "simulate_async_rounds"]
