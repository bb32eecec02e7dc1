from repro_torch.kernels.mvm_tile.ops import mvm, mvm_ref  # noqa: F401
