"""The port's parallel runtime: the (dp, mp) mesh over torch.distributed."""
