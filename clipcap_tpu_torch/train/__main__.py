from clipcap_tpu_torch.train.train import start_training

if __name__ == "__main__":
    exit(start_training())
