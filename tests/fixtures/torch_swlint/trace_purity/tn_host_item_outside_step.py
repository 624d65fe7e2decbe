"""TN: .item() and nonzero on the host side, in a function no step root
reaches."""
import torch


def summarize(counts):
    top = torch.nonzero(counts).flatten()
    return counts.sum().item(), top.tolist()
