// cdt_loadgen — native load generator for the detection daemon bench of
// the PyTorch port.
//
// The port's own copy of the JAX package's native/cdt_loadgen.cpp, the same
// program under the same contract. `python -m cough_detector_tpu_torch.cli.bench
// --daemon` measures the port's serve/server.py end to end by feeding it
// real-time 100 ms PCM frames over loopback sockets. Its Python client
// processes (cli/bench.py::_daemon_client_main) encode every frame in the
// interpreter: at thousands of streams the frame encodes across client
// processes saturate a host with few cores before the server under test
// does, and the bench's max_client_late guard voids every row past that
// count. This binary
// is the same load generator with the per-frame cost moved to C++: one
// process opens N slots on one socket, paces frames on an absolute
// monotonic deadline, and counts delivered EVENT frames on a reader
// thread, so the measured ceiling is the server's again.
//
// Speaks the wire protocol of the port's serve/protocol.py (12-byte LE
// header: magic u16 0x0CD7, type u8, flags u8, stream u32, length u32) —
// byte-compatible by construction with both the Python server loop and
// the native (native/cdt_ingest.cpp) plane.
//
// Built by utils/native_build.py::build_executable into
// build/native/cdt_loadgen-<hash>.
//
// Usage:
//   cdt_loadgen HOST PORT N_SLOTS N_FRAMES TICK_US CHUNK CLIP.f32
//
// Contract with the parent (same as the Python generator):
//   prints "READY\n" once all slots are granted, waits for one line on
//   stdin ("GO"), feeds N_FRAMES ticks, then prints
//   "EVENTS <n> LATE <seconds>\n" where LATE is how far behind the
//   real-time schedule the feed loop finished (the parent voids the row
//   if the load was not actually offered on time).
//
// CLIP.f32 is raw float32le mono PCM at the model rate; frames cycle
// through it exactly like the Python generator's
// `lo = (f*chunk) % (clip.size - chunk)`.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kMagic = 0x0CD7;
constexpr uint8_t kOpen = 1, kOpened = 2, kAudio = 3, kEvent = 4,
                  kError = 6;
constexpr size_t kHeader = 12;

void put_header(uint8_t* p, uint8_t type, uint32_t stream, uint32_t len) {
  p[0] = kMagic & 0xff;
  p[1] = kMagic >> 8;
  p[2] = type;
  p[3] = 0;
  memcpy(p + 4, &stream, 4);  // x86/arm64: host order is little-endian
  memcpy(p + 8, &len, 4);
}

bool send_all(int fd, const uint8_t* p, size_t n) {
  while (n) {
    ssize_t w = send(fd, p, n, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_exact(int fd, uint8_t* p, size_t n) {
  while (n) {
    ssize_t r = recv(fd, p, n, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    if (r == 0) return false;  // EOF
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

std::atomic<long> g_events{0};
std::atomic<bool> g_refused{false};
std::atomic<bool> g_reader_dead{false};  // reader exited (EOF/bad frame)
std::atomic<bool> g_handshake_done{false};
std::mutex g_slots_mu;
std::vector<uint32_t> g_slots;  // granted ids, in OPENED arrival order

// Reader: captures OPENED slot ids during the handshake, counts EVENT
// frames forever after, tolerates (skips) everything else. Exits on
// EOF/error — after the main loop shuts the socket down, that is the
// orderly way out.
void reader_loop(int fd) {
  // Whatever path exits this loop (EOF, bad magic, refusal), flag it:
  // main's handshake wait would otherwise spin forever on a connection
  // that died mid-handshake (server crash/reset after our OPENs).
  struct DeadFlag {
    ~DeadFlag() { g_reader_dead.store(true); }
  } on_exit;
  std::vector<uint8_t> payload(1 << 16);
  uint8_t head[kHeader];
  for (;;) {
    if (!recv_exact(fd, head, kHeader)) return;
    uint16_t magic = uint16_t(head[0]) | uint16_t(head[1]) << 8;
    if (magic != kMagic) {
      fprintf(stderr, "cdt_loadgen: bad magic 0x%04x\n", magic);
      return;
    }
    uint8_t type = head[2];
    uint32_t stream, len;
    memcpy(&stream, head + 4, 4);
    memcpy(&len, head + 8, 4);
    if (len > payload.size()) payload.resize(len);
    if (len && !recv_exact(fd, payload.data(), len)) return;
    if (type == kEvent) {
      g_events.fetch_add(1, std::memory_order_relaxed);
    } else if (type == kOpened) {
      std::lock_guard<std::mutex> lk(g_slots_mu);
      g_slots.push_back(stream);
    } else if (type == kError) {
      fprintf(stderr, "cdt_loadgen: server error: %.*s\n", int(len),
              reinterpret_cast<char*>(payload.data()));
      if (!g_handshake_done.load()) {
        // A refusal mid-handshake (no free slots) voids the run; an
        // out-of-band ERROR later is informational, like the Python
        // client's server_errors list.
        g_refused.store(true);
        return;
      }
    }
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 8) {
    fprintf(stderr,
            "usage: cdt_loadgen HOST PORT N_SLOTS N_FRAMES TICK_US CHUNK "
            "CLIP.f32\n");
    return 2;
  }
  const char* host = argv[1];
  int port = atoi(argv[2]);
  size_t n_slots = size_t(atol(argv[3]));
  long n_frames = atol(argv[4]);
  int64_t tick_ns = atol(argv[5]) * 1000;
  size_t chunk = size_t(atol(argv[6]));

  // Clip: raw f32le samples, cycled with the Python generator's stride.
  FILE* f = fopen(argv[7], "rb");
  if (!f) {
    perror("cdt_loadgen: clip");
    return 2;
  }
  struct stat st;
  fstat(fileno(f), &st);
  size_t n_samples = size_t(st.st_size) / 4;
  if (n_samples < chunk + 1) {
    fprintf(stderr, "cdt_loadgen: clip shorter than one chunk\n");
    return 2;
  }
  std::vector<float> clip(n_samples);
  if (fread(clip.data(), 4, n_samples, f) != n_samples) {
    fprintf(stderr, "cdt_loadgen: short clip read\n");
    return 2;
  }
  fclose(f);

  int fd = socket(AF_INET, SOCK_STREAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    fprintf(stderr, "cdt_loadgen: bad host %s (IPv4 literal only)\n", host);
    return 2;
  }
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("cdt_loadgen: connect");
    return 2;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));

  std::thread reader(reader_loop, fd);
  // Early exits after this point must unwind the reader: returning with
  // a joinable std::thread calls std::terminate (SIGABRT) instead of
  // reporting the exit code.
  auto bail = [&](int code) {
    shutdown(fd, SHUT_RDWR);
    if (reader.joinable()) reader.join();
    close(fd);
    return code;
  };

  // Handshake: batch all OPENs in one write; the server replies one
  // OPENED per grant carrying the slot id (ids are NOT assumed
  // contiguous — the reader records exactly what was granted).
  {
    std::vector<uint8_t> opens(n_slots * kHeader);
    for (size_t i = 0; i < n_slots; ++i)
      put_header(opens.data() + i * kHeader, kOpen, 0, 0);
    if (!send_all(fd, opens.data(), opens.size())) {
      fprintf(stderr, "cdt_loadgen: open send failed\n");
      return bail(2);
    }
  }
  std::vector<uint32_t> slots;
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(g_slots_mu);
      if (g_slots.size() >= n_slots) {
        slots = g_slots;
        break;
      }
    }
    if (g_refused.load()) return bail(2);
    if (g_reader_dead.load()) {
      size_t got;
      {
        std::lock_guard<std::mutex> lk(g_slots_mu);
        got = g_slots.size();
      }
      fprintf(stderr,
              "cdt_loadgen: connection died mid-handshake "
              "(%zu/%zu slots granted)\n",
              got, n_slots);
      return bail(2);
    }
    usleep(1000);
  }
  g_handshake_done.store(true);

  // One tick = one contiguous buffer holding every slot's AUDIO frame.
  // Headers are constant across ticks; only the payload bytes change.
  const size_t frame_bytes = kHeader + chunk * 4;
  std::vector<uint8_t> tick_buf(n_slots * frame_bytes);
  for (size_t i = 0; i < n_slots; ++i)
    put_header(tick_buf.data() + i * frame_bytes, kAudio, slots[i],
               uint32_t(chunk * 4));

  printf("READY\n");
  fflush(stdout);
  {
    char line[64];
    if (!fgets(line, sizeof(line), stdin)) return bail(2);  // GO
  }

  const int64_t t0 = now_ns();
  int64_t next = t0 + tick_ns;
  bool send_failed = false;
  for (long fnum = 0; fnum < n_frames && !send_failed; ++fnum) {
    int64_t delay = next - now_ns();
    if (delay > 0) {
      timespec ts{time_t(delay / 1000000000), long(delay % 1000000000)};
      nanosleep(&ts, nullptr);
    }
    next += tick_ns;
    const size_t lo = (size_t(fnum) * chunk) % (n_samples - chunk);
    const uint8_t* window =
        reinterpret_cast<const uint8_t*>(clip.data() + lo);
    for (size_t i = 0; i < n_slots; ++i)
      memcpy(tick_buf.data() + i * frame_bytes + kHeader, window,
             chunk * 4);
    if (!send_all(fd, tick_buf.data(), tick_buf.size())) {
      fprintf(stderr, "cdt_loadgen: audio send failed (server gone?)\n");
      send_failed = true;
    }
  }
  // How far behind the real-time schedule this generator finished: if
  // the CLIENT could not offer the load, the server row is void.
  const double late =
      double(now_ns() - (t0 + n_frames * tick_ns)) / 1e9;

  usleep(500000);  // let the tail tick's events arrive
  const long events = g_events.load();
  printf("EVENTS %ld LATE %.3f\n", events, late);
  fflush(stdout);

  shutdown(fd, SHUT_RDWR);
  reader.join();
  close(fd);
  return send_failed ? 1 : 0;
}
