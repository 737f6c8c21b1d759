"""An archive through ``reprocess_corpus`` over a ``dp`` mesh: the corpus
client (``clients/corpus.py``: passes over a corpus of WAVs, each into an
output directory of its own) with ``mesh=make_mesh({"dp": dp})``, ``dp`` the
configuration's ``runner.dp``: over the visible cards, or over the run's
device ``dp`` times on the CPU.  The runner cuts each batch into ``dp`` runs,
one a device (``parallel/batch.dispatch_batch``).
"""

from __future__ import annotations

from portbench.clients import corpus


class Client(corpus.Client):
    def __init__(self, config, traffic, seed, device, workdir, recorder):
        super().__init__(config, traffic, seed, device, workdir, recorder)
        import torch

        from axctdprocessor_tpu_torch.parallel.mesh import make_mesh

        dp = int(config["runner"]["dp"])
        cards = torch.device(device).type == "cuda"
        self._kw["mesh"] = make_mesh({"dp": dp}, None if cards else [device] * dp)
