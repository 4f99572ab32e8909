from krr_tpu_torch.main import run

if __name__ == "__main__":
    run()
