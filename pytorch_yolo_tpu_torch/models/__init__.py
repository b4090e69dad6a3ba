"""Network definitions (Darknet forward as an ``nn.Module``)."""
