"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""


def wrappers():
    """Every kernel wrapper of the port (the three backward ones last), by
    the name its `.launches` counter reports under (imported here, at call time: the wrappers import
    `runtime`, which imports this package)."""
    from repro_torch.kernels.decode_attention import ops as ddops
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.paged_decode_attention import ops as dops
    from repro_torch.kernels.paged_prefill_attention import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.ssm_scan import ops as sops
    return {fn.__name__: fn for fn in (
        dops.paged_decode_attention, pops.paged_prefill_attention_ragged,
        pops.paged_prefill_attention, dops.paged_decode_attention_quant,
        pops.paged_prefill_attention_ragged_quant,
        pops.paged_prefill_attention_quant, ddops.decode_attention,
        faops.flash_attention, sops.ssm_scan, rops.rmsnorm,
        faops.flash_attention_bwd, sops.ssm_scan_bwd, rops.rmsnorm_bwd)}
