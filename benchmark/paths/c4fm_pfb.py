"""P25 C4FM control through the pfb frontend: ``ControlPipeline.step`` =
``PfbXlatBank.call_planes`` (the coarse bins by ``pfb_bins``, the fine
stage on ``xlat_complex``'s general path, ``planes()``' copies) then the
fused tracker (``fsk_track``)."""

from benchmark.core.c4fm import C4fmPath


class Path(C4fmPath):
    frontend = "pfb"
    reference = "pfb"
    work = {"channelize": "pfb_bank", "demod": "fsk_track"}

    def chan_state(self, bs) -> dict:
        return {"pfb.history": bs.pfb.history.clone(),
                "fine.history": bs.fine.history.clone(),
                "fine.phase": bs.fine.phase.clone()}
