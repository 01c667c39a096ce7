"""SDM-DSGD core: the paper's algorithm as PyTorch modules.

Counterpart of ``repro.core``: ``method`` is the registry, ``sdm_dsgd``
/ ``baselines`` the stacked reference and per-node executors,
``compressor`` / ``plane`` / ``sparsifier`` / ``clipping`` the wire
path, ``gossip`` the schedules, dense mixing and per-node exchanges,
``transport`` the node blocks the exchanges ride, ``wire_count`` the
expected sends and bytes, and ``topology`` /
``privacy`` / ``theory`` the port's own copies of the JAX package's
framework-free modules.
"""
from repro_torch.core import (baselines, clipping, compressor, gossip, method,
                              plane, privacy, sdm_dsgd, sparsifier, theory,
                              topology, transport, wire_count)
from repro_torch.core.baselines import DSGDConfig, DSGDReference, dcdsgd_config
from repro_torch.core.privacy import PrivacyAccountant, PrivacyParams
from repro_torch.core.sdm_dsgd import (ReferenceSimulator, SDMConfig, SDMState,
                                       compressor_of, masked_grad,
                                       transmitted_bits_per_step,
                                       transmitted_elements_per_step)

__all__ = ["SDMConfig", "SDMState", "ReferenceSimulator", "masked_grad",
           "compressor_of", "transmitted_elements_per_step",
           "transmitted_bits_per_step", "DSGDConfig", "DSGDReference",
           "dcdsgd_config", "PrivacyParams", "PrivacyAccountant", "topology",
           "theory", "sparsifier", "gossip", "clipping", "compressor",
           "method", "plane", "privacy", "baselines", "sdm_dsgd",
           "transport", "wire_count"]
