from repro_torch.kernels.fake_quant.fake_quant import fake_quant, fake_quant_any
