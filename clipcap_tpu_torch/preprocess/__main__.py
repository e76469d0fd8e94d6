from clipcap_tpu_torch.preprocess.preprocess import start_preprocess

if __name__ == "__main__":
    exit(start_preprocess())
